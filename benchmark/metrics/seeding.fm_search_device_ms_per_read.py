"""FM seeding's exact search, both strands' seed pieces (ops/fm.py
backward_search): stream ms per read, the port's ``device_s`` entry
``fm_search``, the time on the batch's stream between CUDA events
recorded around the part's launches (pipeline/seeding.py), read after
the ``seed_hits`` stage's synchronize. None where the program records
no such entry (the k-mer backend, or a program without FM spans)."""


def read(ctx):
    d = ctx["stats"].get("device_s", {}).get("fm_search")
    return None if d is None or not ctx["reads"] else 1e3 * d / ctx["reads"]
