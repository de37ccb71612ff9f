// FM index build on every host core (index/fm_build.py drives it).
//
//   lamsa_fm_text    the suffix sort's text: codes with N substituted by
//                    index/fmindex.py substitute_n's position hash, +1,
//                    and a sentinel 0 — one n+1-byte array
//   lamsa_fm_sais    SA-IS (Nong/Zhang/Chan) with its passes split over
//                    threads; the suffix array is unique, so it equals
//                    lamsa_native.cpp's sequential lamsa_sais_u8 bit for bit
//   lamsa_fm_arrays  bwt2, occ, ssa_marks, ssa_rankcp and ssa_pos from the
//                    suffix array in two parallel sweeps over 64-row slices
//
// SA-IS here keeps lamsa_native.cpp's structure: induced sorting with
// recursion on the reduced text, and the reduced text and the LMS
// position table held in SA's free tail. What differs:
//   * the suffix type is the text symbol's top bit (a level's text is
//     this routine's own buffer: the caller's at level 0, SA's tail below;
//     symbols stay below it, K <= 128 for bytes, < 2^31 for names), so an
//     induce step reads one random byte or word, not two, and no type
//     array is allocated;
//   * each induce sweep runs block by block (after libsais): threads
//     read a block's entries and their predecessors' symbols and types
//     into a cache, the block's bucket slots are assigned in scan order,
//     then threads scatter the block; blocks stay in order, so the sweep
//     writes what the sequential sweep writes. Slots come from per-thread
//     symbol counts where the alphabet is small and no slot falls inside
//     the block, else from one thread's walk of the cache (an entry that
//     lands inside the block is written into the cache, where the walk
//     reads it);
//   * types, histograms, LMS placement and compaction, the naming
//     compares and prefix, the reduced-SA mapping and the final LMS
//     placement run on slices of the text, one per thread.
// Beyond the bucket arrays of K symbols a level, as the sequential
// version has, the extra memory is the cache (threads x BLOCK_PER_THREAD
// x 8 bytes) and per-thread bucket counts (threads x K, K small): no
// type or name-difference arrays of the text's length. Indices are
// uint32 (texts up to 2^32 - 1 with the sentinel); offsets and counts are
// int64.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <exception>
#include <mutex>
#include <thread>
#include <vector>

namespace {

const uint32_t EMPTY = 0xFFFFFFFFu;
const int64_t BLOCK_PER_THREAD = 1 << 16;   // induce cache entries a thread
const int64_t PAR_MIN = 1 << 20;            // levels below run on one thread
const int64_t SMALL_K = 1 << 16;            // per-thread bucket arrays up to
const int64_t SPEC_K = 256;                 // speculative induce blocks up to
const int PF = 32;                          // prefetch distance (entries)
const int SPIN = 1 << 14;                   // barrier spins before sleeping

// Per-thread arrays of K counters, a cache line apart.
inline int64_t stride(int64_t K) { return (K + 31) & ~(int64_t)15; }

inline void cpu_relax() {
#if defined(__x86_64__) || defined(__i386__)
    __builtin_ia32_pause();
#elif defined(__aarch64__)
    asm volatile("yield");
#endif
}

// Waiters spin a while before they sleep: a block's phases are
// milliseconds long, and a sleeping thread takes tens of microseconds to
// wake.
class Barrier {
    std::mutex m_;
    std::condition_variable cv_;
    int n_, waiting_ = 0;
    std::atomic<uint64_t> gen_{0};

public:
    explicit Barrier(int n) : n_(n) {}
    void wait() {
        if (n_ == 1) return;
        std::unique_lock<std::mutex> lk(m_);
        uint64_t g = gen_.load(std::memory_order_relaxed);
        if (++waiting_ == n_) {
            waiting_ = 0;
            gen_.store(g + 1, std::memory_order_release);
            cv_.notify_all();
            return;
        }
        lk.unlock();
        for (int i = 0; i < SPIN; i++) {
            if (gen_.load(std::memory_order_acquire) != g) return;
            cpu_relax();
        }
        lk.lock();
        cv_.wait(lk, [&] { return gen_.load(std::memory_order_acquire) != g; });
    }
};

// fn(t, barrier) on nt threads, the caller being thread 0; returns when
// all have.
template <class F>
void team(int nt, F&& fn) {
    Barrier bar(nt);
    std::vector<std::thread> ths;
    ths.reserve(nt - 1);
    for (int t = 1; t < nt; t++) ths.emplace_back([&fn, &bar, t] { fn(t, bar); });
    fn(0, bar);
    for (auto& th : ths) th.join();
}

// Slice t of nt of [0, n).
inline void slice(int64_t n, int nt, int t, int64_t* lo, int64_t* hi) {
    *lo = n * t / nt;
    *hi = n * (t + 1) / nt;
}

// fn(t, lo, hi) over nt slices of [0, n) (on the caller alone for nt 1).
template <class F>
void pfor(int nt, int64_t n, F&& fn) {
    team(nt, [&](int t, Barrier&) {
        int64_t lo, hi;
        slice(n, nt, t, &lo, &hi);
        fn(t, lo, hi);
    });
}

void pfill(int nt, uint32_t* p, int64_t n, uint32_t v) {
    pfor(n < PAR_MIN ? 1 : nt, n,
         [&](int, int64_t lo, int64_t hi) { std::fill(p + lo, p + hi, v); });
}

template <typename C>
struct Text {
    static constexpr C TB = (C)((C)1 << (sizeof(C) * 8 - 1));   // S type
    const C* T;
    C sym(int64_t i) const { return T[i] & (C)~TB; }
    bool lms(int64_t i) const { return i > 0 && (T[i] & TB) && !(T[i - 1] & TB); }
};

// Sets the S-type bit of every symbol. Each thread types its slice right
// to left; the run of symbols equal to the next slice's first one at a
// slice's end takes that symbol's type, set afterwards from the last
// slice to the first.
template <typename C>
void set_types(C* T, int64_t n, int nt) {
    const C TB = Text<C>::TB;
    std::vector<int64_t> pend(nt);
    team(nt, [&](int t, Barrier& bar) {
        int64_t lo, hi;
        slice(n, nt, t, &lo, &hi);
        C next = hi < n ? T[hi] : 0;        // read before any bit is set
        bar.wait();
        pend[t] = hi;
        if (lo >= hi) return;
        int64_t i;
        C v1;
        bool s1 = false;
        if (hi == n) {
            v1 = T[n - 1];
            s1 = true;
            T[n - 1] |= TB;
            i = n - 2;
        } else {
            v1 = next;
            for (i = hi - 1; i >= lo && T[i] == v1; i--) {}
            pend[t] = i + 1;
        }
        for (; i >= lo; i--) {
            C v = T[i];
            bool s = v < v1 || (v == v1 && s1);
            if (s) T[i] = v | TB;
            v1 = v;
            s1 = s;
        }
    });
    for (int t = nt - 1; t >= 0; t--) {
        int64_t lo, hi;
        slice(n, nt, t, &lo, &hi);
        if (hi < n && (T[hi] & TB))
            for (int64_t i = pend[t]; i < hi; i++) T[i] |= TB;
    }
}

template <typename C>
void clear_types(C* T, int64_t n, int nt) {
    const C keep = (C)~Text<C>::TB;
    auto clr = [&](int, int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; i++) T[i] &= keep;
    };
    pfor(nt, n, clr);
}

// Symbol counts (the types already set).
template <typename C>
void histogram(const C* T, int64_t n, int64_t K, uint32_t* cnt, int nt) {
    Text<C> X{T};
    std::fill(cnt, cnt + K, 0u);
    if (nt == 1) {
        for (int64_t i = 0; i < n; i++) cnt[X.sym(i)]++;
    } else if (K <= SMALL_K) {
        const int64_t S = stride(K);
        std::vector<uint32_t> loc((size_t)nt * S, 0u);
        pfor(nt, n, [&](int t, int64_t lo, int64_t hi) {
            uint32_t* c = loc.data() + (size_t)t * S;
            for (int64_t i = lo; i < hi; i++) c[X.sym(i)]++;
        });
        for (int t = 0; t < nt; t++)
            for (int64_t c = 0; c < K; c++) cnt[c] += loc[(size_t)t * S + c];
    } else {
        pfor(nt, n, [&](int, int64_t lo, int64_t hi) {
            for (int64_t i = lo; i < hi; i++)
                __atomic_fetch_add(&cnt[X.sym(i)], 1u, __ATOMIC_RELAXED);
        });
    }
}

void fill_bkt(const uint32_t* cnt, int64_t K, uint32_t* bkt, bool ends) {
    uint32_t sum = 0;
    for (int64_t c = 0; c < K; c++) {
        sum += cnt[c];
        bkt[c] = ends ? sum : sum - cnt[c];
    }
}

struct Ent {
    uint32_t v;   // the suffix to induce
    uint32_t c;   // its symbol, then its slot; EMPTY: none
};

// One induce sweep: L (left to right, bucket heads) or S (right to
// left, bucket tails). With several threads it runs block by block:
// threads read the block's entries and their predecessors into the
// cache E, then the slots are assigned in scan order, then threads
// write the block's predecessors to their slots. Slots go one of two
// ways. For small K, each thread counts its part's symbols and the
// slots follow from those counts, unless one of them lies inside the
// block: an entry would then arrive in the block after it was read.
// Otherwise (and then) one thread walks E in scan order, and writes an
// entry that lands in the block into E, where the walk reads it.
template <typename C, bool L>
void induce_sweep(const C* T, uint32_t* SA, int64_t n, const uint32_t* cnt,
                  int64_t K, uint32_t* bkt, int nt, std::vector<Ent>& cache) {
    const C TB = Text<C>::TB;
    fill_bkt(cnt, K, bkt, !L);
    // predecessor of suffix j if it is of this sweep's type
    auto pred = [&](uint32_t j, Ent& e) {
        if (j != EMPTY && j > 0) {
            C x = T[j - 1];
            if (((x & TB) != 0) != L) {
                e.v = j - 1;
                e.c = (uint32_t)(x & (C)~TB);
                return;
            }
        }
        e.c = EMPTY;
    };
    if (nt == 1) {
        if (L) {
            for (int64_t i = 0; i < n; i++) {
                if (i + PF < n) {
                    uint32_t jj = SA[i + PF];
                    if (jj != EMPTY && jj > 0) __builtin_prefetch(&T[jj - 1]);
                }
                Ent e;
                pred(SA[i], e);
                if (e.c != EMPTY) SA[bkt[e.c]++] = e.v;
            }
        } else {
            for (int64_t i = n; i-- > 0;) {
                if (i >= PF) {
                    uint32_t jj = SA[i - PF];
                    if (jj != EMPTY && jj > 0) __builtin_prefetch(&T[jj - 1]);
                }
                Ent e;
                pred(SA[i], e);
                if (e.c != EMPTY) SA[--bkt[e.c]] = e.v;
            }
        }
        return;
    }
    const int64_t B = (int64_t)nt * BLOCK_PER_THREAD, nblocks = (n + B - 1) / B;
    const bool spec = K <= SPEC_K;
    const int64_t S = stride(K);
    std::vector<uint32_t> part(spec ? (size_t)nt * S : 0);   // counts, then slots
    Ent* E = cache.data();
    bool walk = false;
    team(nt, [&](int t, Barrier& bar) {
        uint32_t* mine = spec ? part.data() + (size_t)t * S : nullptr;
        for (int64_t bi = 0; bi < nblocks; bi++) {
            int64_t b0 = L ? bi * B : std::max<int64_t>(0, n - (bi + 1) * B);
            int64_t b1 = L ? std::min(n, b0 + B) : n - bi * B;
            int64_t len = b1 - b0, lo, hi;
            slice(len, nt, t, &lo, &hi);
            if (spec) std::fill(mine, mine + K, 0u);
            for (int64_t k = lo; k < hi; k++) {
                if (k + PF < hi) {
                    uint32_t jj = SA[b0 + k + PF];
                    if (jj != EMPTY && jj > 0) __builtin_prefetch(&T[jj - 1]);
                }
                pred(SA[b0 + k], E[k]);
                if (spec && E[k].c != EMPTY) mine[E[k].c]++;
            }
            bar.wait();
            if (t == 0) {
                walk = !spec;
                for (int64_t c = 0; c < K && !walk; c++) {
                    uint32_t m = 0;
                    for (int u = 0; u < nt; u++) m += part[(size_t)u * S + c];
                    walk = m && (L ? (int64_t)bkt[c] < b1 : (int64_t)bkt[c] > b0);
                }
                if (walk && L) {
                    for (int64_t k = 0; k < len; k++) {
                        uint32_t c = E[k].c;
                        if (c == EMPTY) continue;
                        uint32_t p = bkt[c]++;
                        E[k].c = p;
                        if ((int64_t)p < b1) pred(E[k].v, E[p - b0]);
                    }
                } else if (walk) {
                    for (int64_t k = len; k-- > 0;) {
                        uint32_t c = E[k].c;
                        if (c == EMPTY) continue;
                        uint32_t p = --bkt[c];
                        E[k].c = p;
                        if ((int64_t)p >= b0) pred(E[k].v, E[p - b0]);
                    }
                } else {
                    // each part's first slot per symbol, parts in scan order
                    for (int64_t c = 0; c < K; c++) {
                        for (int u = 0; u < nt; u++) {
                            uint32_t* q = &part[(size_t)(L ? u : nt - 1 - u) * S + c];
                            uint32_t m = *q;
                            *q = bkt[c];
                            bkt[c] = L ? bkt[c] + m : bkt[c] - m;
                        }
                    }
                }
            }
            bar.wait();
            if (walk) {
                for (int64_t k = lo; k < hi; k++) {
                    if (k + PF < hi && E[k + PF].c != EMPTY)
                        __builtin_prefetch(&SA[E[k + PF].c], 1);
                    if (E[k].c != EMPTY) SA[E[k].c] = E[k].v;
                }
            } else if (L) {
                for (int64_t k = lo; k < hi; k++)
                    if (E[k].c != EMPTY) SA[mine[E[k].c]++] = E[k].v;
            } else {
                for (int64_t k = hi; k-- > lo;)
                    if (E[k].c != EMPTY) SA[--mine[E[k].c]] = E[k].v;
            }
            bar.wait();
        }
    });
}

template <typename C>
void induce(const C* T, uint32_t* SA, int64_t n, const uint32_t* cnt,
            int64_t K, uint32_t* bkt, int nt) {
    std::vector<Ent> cache;
    if (nt > 1) cache.resize((size_t)nt * BLOCK_PER_THREAD);
    induce_sweep<C, true>(T, SA, n, cnt, K, bkt, nt, cache);
    induce_sweep<C, false>(T, SA, n, cnt, K, bkt, nt, cache);
}

// Per-thread exclusive offsets of per-slice counts; returns the total.
int64_t exclusive(std::vector<int64_t>& v) {
    int64_t s = 0;
    for (auto& x : v) {
        int64_t c = x;
        x = s;
        s += c;
    }
    return s;
}

// LMS suffixes at the ends of their buckets, in descending text order
// within a bucket (as the sequential placement leaves them). With
// per-thread counts (small K), lmsc gets the LMS count of each symbol.
template <typename C>
void place_lms(const C* T, uint32_t* SA, int64_t n, const uint32_t* cnt,
               int64_t K, uint32_t* bkt, int nt, std::vector<uint32_t>& lmsc) {
    Text<C> X{T};
    fill_bkt(cnt, K, bkt, true);
    if (nt == 1 || K > SMALL_K) {
        for (int64_t i = 1; i < n; i++)
            if (X.lms(i)) SA[--bkt[X.sym(i)]] = (uint32_t)i;
        return;
    }
    const int64_t S = stride(K);
    std::vector<uint32_t> ptr((size_t)nt * S, 0u);
    pfor(nt, n, [&](int t, int64_t lo, int64_t hi) {
        uint32_t* c = ptr.data() + (size_t)t * S;
        for (int64_t i = std::max<int64_t>(lo, 1); i < hi; i++)
            if (X.lms(i)) c[X.sym(i)]++;
    });
    lmsc.assign(K, 0u);
    for (int64_t c = 0; c < K; c++) {
        uint32_t end = bkt[c];
        for (int t = 0; t < nt; t++) {
            uint32_t m = ptr[(size_t)t * S + c];
            ptr[(size_t)t * S + c] = end;
            end -= m;
            lmsc[c] += m;
        }
    }
    pfor(nt, n, [&](int t, int64_t lo, int64_t hi) {
        uint32_t* p = ptr.data() + (size_t)t * S;
        for (int64_t i = std::max<int64_t>(lo, 1); i < hi; i++)
            if (X.lms(i)) SA[--p[X.sym(i)]] = (uint32_t)i;
    });
}

// Moves the entries of SA[0, n) that keep(v) accepts to SA's front (or,
// toward_end, to SA's back), in order; returns how many.
template <class F>
int64_t compact(uint32_t* SA, int64_t n, int nt, bool toward_end, F&& keep) {
    if (n < PAR_MIN) nt = 1;
    std::vector<int64_t> got(nt);
    pfor(nt, n, [&](int t, int64_t lo, int64_t hi) {
        int64_t m = 0;
        if (!toward_end) {
            for (int64_t i = lo; i < hi; i++) {
                uint32_t v = SA[i];
                if (keep(v)) SA[lo + m++] = v;
            }
        } else {
            for (int64_t i = hi; i-- > lo;) {
                uint32_t v = SA[i];
                if (keep(v)) SA[hi - 1 - m++] = v;
            }
        }
        got[t] = m;
    });
    int64_t total = 0;
    if (!toward_end) {
        for (int t = 0; t < nt; t++) {
            int64_t lo, hi;
            slice(n, nt, t, &lo, &hi);
            if (got[t] && total != lo)
                memmove(SA + total, SA + lo, got[t] * sizeof(uint32_t));
            total += got[t];
        }
    } else {
        for (int t = nt - 1; t >= 0; t--) {
            int64_t lo, hi;
            slice(n, nt, t, &lo, &hi);
            total += got[t];
            if (got[t] && n - total != hi - got[t])
                memmove(SA + n - total, SA + hi - got[t], got[t] * sizeof(uint32_t));
        }
    }
    return total;
}

template <typename C>
void sais(C* T, uint32_t* SA, int64_t n, int64_t K, int nt) {
    if (n < PAR_MIN) nt = 1;
    Text<C> X{T};
    set_types(T, n, nt);
    std::vector<uint32_t> cnt(K), bkt(K);
    histogram(T, n, K, cnt.data(), nt);

    pfill(nt, SA, n, EMPTY);
    std::vector<uint32_t> lmsc;
    place_lms(T, SA, n, cnt.data(), K, bkt.data(), nt, lmsc);
    induce(T, SA, n, cnt.data(), K, bkt.data(), nt);

    // the LMS suffixes, sorted by their LMS substrings, to SA[0, n1)
    int64_t n1 = compact(SA, n, nt, false, [&](uint32_t v) {
        return v != EMPTY && X.lms(v);
    });
    pfill(nt, SA + n1, n - n1, EMPTY);

    // name them: SA[n1 + pos / 2] first holds whether the substring at
    // pos differs from its predecessor's, then its name
    auto differs = [&](int64_t i) -> uint32_t {
        if (i == 0) return 1;
        int64_t pos = SA[i], prev = SA[i - 1];
        for (int64_t d = 0;; d++) {
            if (pos + d == n || prev + d == n || T[pos + d] != T[prev + d])
                return 1;
            if (d > 0 && (X.lms(pos + d) || X.lms(prev + d)))
                return !(X.lms(pos + d) && X.lms(prev + d));
        }
    };
    const int nt1 = n1 < PAR_MIN ? 1 : nt;   // for passes over SA[0, n1)
    int64_t name = 0;
    if (n1 > 0) {
        std::vector<int64_t> names(nt1);
        pfor(nt1, n1, [&](int t, int64_t lo, int64_t hi) {
            int64_t m = 0;
            for (int64_t i = lo; i < hi; i++) {
                if (i + PF < hi) __builtin_prefetch(&T[SA[i + PF]]);
                uint32_t d = differs(i);
                SA[n1 + SA[i] / 2] = d;
                m += d;
            }
            names[t] = m;
        });
        name = exclusive(names);
        pfor(nt1, n1, [&](int t, int64_t lo, int64_t hi) {
            int64_t m = names[t];
            for (int64_t i = lo; i < hi; i++) {
                uint32_t* slot = &SA[n1 + SA[i] / 2];
                m += *slot;
                *slot = (uint32_t)(m - 1);
            }
        });
    }
    // the reduced text s1 = SA[n - n1, n), the names in text order
    compact(SA + n1, n - n1, nt, true, [](uint32_t v) { return v != EMPTY; });
    uint32_t* s1 = SA + n - n1;

    if (name < n1) {
        sais<uint32_t>(s1, SA, n1, name, nt);
    } else {
        pfor(nt1, n1, [&](int, int64_t lo, int64_t hi) {
            for (int64_t i = lo; i < hi; i++) SA[s1[i]] = (uint32_t)i;
        });
    }
    // s1 is consumed: the LMS positions in text order take its place,
    // and map the reduced SA's entries to them
    {
        std::vector<int64_t> at(nt);
        pfor(nt, n, [&](int t, int64_t lo, int64_t hi) {
            int64_t m = 0;
            for (int64_t i = std::max<int64_t>(lo, 1); i < hi; i++) m += X.lms(i);
            at[t] = m;
        });
        exclusive(at);
        pfor(nt, n, [&](int t, int64_t lo, int64_t hi) {
            int64_t j = at[t];
            for (int64_t i = std::max<int64_t>(lo, 1); i < hi; i++)
                if (X.lms(i)) s1[j++] = (uint32_t)i;
        });
    }
    pfor(nt1, n1, [&](int, int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; i++) {
            if (i + PF < hi) __builtin_prefetch(&s1[SA[i + PF]]);
            SA[i] = s1[SA[i]];
        }
    });
    // the sorted LMS suffixes to their buckets' ends
    fill_bkt(cnt.data(), K, bkt.data(), true);
    if (lmsc.empty()) {
        pfill(nt, SA + n1, n - n1, EMPTY);
        for (int64_t i = n1; i-- > 0;) {
            uint32_t j = SA[i];
            SA[i] = EMPTY;
            SA[--bkt[X.sym(j)]] = j;
        }
    } else {
        // bucket c's sorted entries are one run of SA[0, n1): move the
        // runs from the last bucket down, then clear the rest
        for (int64_t c = K, first = n1; c-- > 0;) {
            first -= lmsc[c];
            if (lmsc[c])
                memmove(SA + bkt[c] - lmsc[c], SA + first, lmsc[c] * sizeof(uint32_t));
        }
        for (int64_t c = 0; c < K; c++) {
            int64_t b0 = (int64_t)bkt[c] - cnt[c];
            pfill(nt, SA + b0, bkt[c] - lmsc[c] - b0, EMPTY);
        }
    }
    induce(T, SA, n, cnt.data(), K, bkt.data(), nt);
    clear_types(T, n, nt);
}

template <bool POW2>
inline bool sampled(uint32_t v, uint32_t rate) {
    return POW2 ? (v & (rate - 1)) == 0 : v % rate == 0;
}

// Occurrences of 2-bit code c among the 16 bases of w.
inline uint32_t count16(uint32_t w, uint32_t c) {
    uint32_t x = w ^ (c * 0x55555555u);
    return __builtin_popcount(~(x | (x >> 1)) & 0x55555555u);
}

template <bool POW2>
int64_t fm_arrays(const uint8_t* T, const uint32_t* SA, int64_t n,
                  uint32_t rate, uint32_t* bwt2, uint32_t* occ,
                  uint32_t* marks, uint32_t* rankcp, uint32_t* ssa_pos,
                  int64_t npos, int64_t* counts, int nt) {
    const int64_t nr = n + 1, nblk = n / 64 + 1;   // 64-row blocks = ncp
    int64_t primary = -1;
    {
        std::vector<int64_t> found(nt, -1);
        pfor(nt, nr, [&](int t, int64_t lo, int64_t hi) {
            for (int64_t i = lo; i < hi; i++)
                if (SA[i] == 0) { found[t] = i; break; }
        });
        for (int t = 0; t < nt && primary < 0; t++) primary = found[t];
    }
    if (primary < 0) return -1;
    // sweep 1: bwt2 words, mark words, per-slice symbol and mark counts
    std::vector<int64_t> sym((size_t)nt * 4, 0), nmarks(nt, 0);
    team(nt, [&](int t, Barrier&) {
        int64_t k0, k1;
        slice(nblk, nt, t, &k0, &k1);
        int64_t r0 = 64 * k0, r1 = std::min(n, 64 * k1);
        int64_t c[4] = {0, 0, 0, 0};
        uint32_t w = 0;
        for (int64_t r = r0; r < r1; r++) {
            int64_t i = r + (r >= primary);
            if (r + PF < r1) __builtin_prefetch(&T[SA[i + PF] - 1]);
            uint32_t b = (uint32_t)T[SA[i] - 1] - 1;
            c[b]++;
            w |= b << (2 * (r & 15));
            if ((r & 15) == 15 || r == r1 - 1) {
                bwt2[r >> 4] = w;
                w = 0;
            }
        }
        for (int b = 0; b < 4; b++) sym[(size_t)t * 4 + b] = c[b];
        int64_t i1 = std::min(nr, 64 * k1), m = 0;
        w = 0;
        for (int64_t i = 64 * k0; i < i1; i++) {
            uint32_t bit = sampled<POW2>(SA[i], rate);
            m += bit;
            w |= bit << (i & 31);
            if ((i & 31) == 31 || i == i1 - 1) {
                marks[i >> 5] = w;
                w = 0;
            }
        }
        nmarks[t] = m;
    });
    for (int b = 0; b < 4; b++) {
        counts[b] = 0;
        for (int t = 0; t < nt; t++) {
            int64_t x = sym[(size_t)t * 4 + b];
            sym[(size_t)t * 4 + b] = counts[b];
            counts[b] += x;
        }
    }
    if (exclusive(nmarks) != npos) return -2;
    // sweep 2: occ and ssa_rankcp at each block's start, ssa_pos
    team(nt, [&](int t, Barrier&) {
        int64_t k0, k1;
        slice(nblk, nt, t, &k0, &k1);
        uint64_t c[4];
        for (int b = 0; b < 4; b++) c[b] = (uint64_t)sym[(size_t)t * 4 + b];
        uint64_t m = (uint64_t)nmarks[t];
        for (int64_t k = k0; k < k1; k++) {
            for (int b = 0; b < 4; b++) occ[4 * k + b] = (uint32_t)c[b];
            rankcp[k] = (uint32_t)m;
            for (int64_t q = 4 * k; q < 4 * k + 4 && 16 * q < n; q++)
                for (int b = 0; b < 4; b++) c[b] += count16(bwt2[q], b);
            for (int64_t q = 2 * k; q < 2 * k + 2 && 32 * q < nr; q++)
                m += __builtin_popcount(marks[q]);
        }
        if (k1 == nblk && nr % 64 == 0) rankcp[nblk] = (uint32_t)m;
        int64_t j = nmarks[t], i1 = std::min(nr, 64 * k1);
        for (int64_t i = 64 * k0; i < i1; i++)
            if (sampled<POW2>(SA[i], rate)) ssa_pos[j++] = SA[i];
    });
    return primary;
}

int clamp_threads(int32_t nt) { return nt < 1 ? 1 : nt; }

}  // namespace

extern "C" {

// T[0, n) = codes with N (>= 4) replaced by the position hash, + 1;
// T[n] = 0 (the sentinel). T has n + 1 bytes.
void lamsa_fm_text(const uint8_t* codes, int64_t n, uint8_t* T, int32_t nt) {
    nt = clamp_threads(nt);
    auto fill = [&](int, int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; i++) {
            uint8_t c = codes[i];
            if (c >= 4) c = (uint8_t)(((uint64_t)i * 0x9E3779B97F4A7C15ull) >> 62);
            T[i] = c + 1;
        }
    };
    pfor(nt, n, fill);
    T[n] = 0;
}

// Suffix array of T[0, n), T[n - 1] = 0 the unique smallest symbol, all
// symbols < K <= 128. T is restored on return. 0 on success.
int lamsa_fm_sais(uint8_t* T, uint32_t* SA, int64_t n, int32_t K, int32_t nt) {
    if (n <= 0 || n > (int64_t)EMPTY || T[n - 1] != 0 || K < 1 || K > 128)
        return -1;
    try {
        sais<uint8_t>(T, SA, n, K, clamp_threads(nt));
    } catch (const std::exception&) {
        return -3;
    }
    return 0;
}

// FmIndex arrays from T (lamsa_fm_text's, n + 1 bytes) and its suffix
// array SA[0, n]. Output sizes: bwt2 (n + 15) / 16, occ 4 (n / 64 + 1),
// marks (n + 32) / 32, rankcp (n + 1) / 64 + 1, ssa_pos npos = n / rate
// + 1; counts[4]. Returns primary (the row of SA value 0), or < 0.
int64_t lamsa_fm_arrays(const uint8_t* T, const uint32_t* SA, int64_t n,
                        int32_t rate, uint32_t* bwt2, uint32_t* occ,
                        uint32_t* marks, uint32_t* rankcp, uint32_t* ssa_pos,
                        int64_t npos, int64_t* counts, int32_t nt) {
    if (n <= 0 || rate < 1) return -1;
    try {
        bool pow2 = (rate & (rate - 1)) == 0;
        auto f = pow2 ? fm_arrays<true> : fm_arrays<false>;
        return f(T, SA, n, (uint32_t)rate, bwt2, occ, marks, rankcp, ssa_pos,
                 npos, counts, clamp_threads(nt));
    } catch (const std::exception&) {
        return -3;
    }
}

}  // extern "C"
