"""1-edit variant tracks per read that the FM re-seed searched: the
port's counter ``fm_1edit_tracks`` (window x track x strand of every
backward_search_1edit). 0 where FM seeding ran (its ``fm_search`` span)
but no read was re-seeded; None where no FM span ran (the k-mer backend,
or a program without FM spans)."""


def read(ctx):
    stats = ctx["stats"]
    if "fm_search" not in stats.get("calls", {}) or not ctx["reads"]:
        return None
    return stats["counters"].get("fm_1edit_tracks", 0) / ctx["reads"]
