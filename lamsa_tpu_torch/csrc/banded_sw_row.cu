// Banded affine-gap DP in row order, with per-instance zdrop and
// best-cell tracking: the CUDA counterpart of the Pallas kernel
// lamsa_tpu/ops/banded_sw_pallas.py `_kernel` (entry banded_sw_pallas,
// pallas_call at :344), whose semantic spec is
// lamsa_tpu/ops/banded_sw_xla.py banded_sw_batch.
//
// Layout ("rolling diagonal", as in the spec): lane d of row i holds DP
// cell (i, j = i + lo + d), d in [0, W). Per row a lane needs
//   diag: its own previous-row H,
//   F:    lane d+1 of the previous row,
//   E:    an exclusive prefix-max over the lanes of this row of
//         V = H' + d*gape, plus its tie bit
//         e_ext[d] = (V[d-1] <= Pexcl[d-1]).
// Direction bytes go to dirs32[b, (i-1)/4, d], byte (i-1)%4 (four rows
// per int32 word, as the TPU layout); words above row m are not
// written. zdrop is checked after every ZDROP_GROUP-th row and only
// freezes best/h_last; the DP itself runs on so that direction bytes
// equal a run without zdrop (lamsa_tpu/ops/oracle.py ZDROP_GROUP).
//
// What bounds it on an H100: about 12 integer operations per band cell
// (H, E, F, the score and the direction bits), so the card's floor is
// its INT32 issue rate; memory is one direction byte per cell plus the
// windows read once. But every instance is a serial chain of m rows,
// and a chunk of the main path holds fewer instances than the card
// holds warps, so what a launch costs is the latency of one row times
// the longest m.
//
// Design, against that latency: one warp per instance, each thread
// owning L = W / 32 consecutive lanes in registers (H, F, target code,
// best score and row, packed direction word), one warp per block, so the
// row loop has no block barrier. Per row one shuffle pair brings lane
// d+1's H and F across the thread edge; the prefix max is a running max
// over the thread's lanes, a 5-step shuffle scan of the thread maxima
// and one max per lane; the tie bit crosses the thread edge by one more
// shuffle. Each max that also yields a direction bit is one Hopper DPX
// instruction (__vibmax_s32), and each add-then-max one more
// (__viaddmax_s32). zdrop (every 32nd row) and the final best-cell fold
// are shuffle reductions. The instance's q and t window are staged once
// into shared memory as bytes, so the loop reads no device memory: q
// four rows at a time, and the lanes' target codes as a shift register
// whose top lane's next four codes are read ahead every four rows. The
// staging is a plain copy loop, not cp.async: cp.async copies bytes as
// they are and cannot narrow the int32 codes, and int32 windows would
// take four times the shared memory (PERF.md has the staging's measured
// share). Warps are persistent: the grid is what the SMs hold (or fewer,
// one warp per instance), and each warp takes its next instance from an
// atomic counter in the order the wrapper gives (longest first), so the
// longest instances start first and a small chunk still spreads one warp
// per SM. L = W / 32 (one warp per instance) won against two instances
// per warp when measured (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace row_dp {

constexpr int NEG = -(1 << 29);
constexpr int ZDROP_GROUP = 32;
constexpr unsigned FULL = 0xffffffffu;

// 4 int32 codes -> 4 bytes; anything but a base (0..3) becomes `bad`
// (4 for q, 5 for t), so a pair matches only if both are the same base
__device__ __forceinline__ uint32_t pack4(int4 v, unsigned bad) {
  const unsigned x = ((unsigned)v.x < 4u) ? (unsigned)v.x : bad;
  const unsigned y = ((unsigned)v.y < 4u) ? (unsigned)v.y : bad;
  const unsigned z = ((unsigned)v.z < 4u) ? (unsigned)v.z : bad;
  const unsigned w = ((unsigned)v.w < 4u) ? (unsigned)v.w : bad;
  return x | (y << 8) | (z << 16) | (w << 24);
}

// count int32 codes (a multiple of 4) -> bytes, by the warp's lane r
__device__ __forceinline__ void stage(uint8_t* dst, const int32_t* src,
                                      int count, unsigned bad, int r) {
  for (int x = 4 * r; x < count; x += 4 * 32)
    *reinterpret_cast<uint32_t*>(dst + x) =
        pack4(*reinterpret_cast<const int4*>(src + x), bad);
}

template <int N>
__device__ __forceinline__ void store4(int32_t* p, const int* v) {
#pragma unroll
  for (int k = 0; k < N; k += 4)
    *reinterpret_cast<int4*>(p + k) =
        make_int4(v[k], v[k + 1], v[k + 2], v[k + 3]);
}

// One DP row of the instance for the thread's L lanes. FAST: the row is
// inside the instance (i <= m) and fully valid (1 <= j <= n on every
// lane), so the validity selects and the activity tests drop out; the
// slow path handles the band's ends.
template <int W, bool FAST>
__device__ __forceinline__ void row_step(int (&h)[W / 32], int (&f)[W / 32],
                                         int (&bls)[W / 32],
                                         int (&blr)[W / 32],
                                         int (&word)[W / 32],
                                         const int (&tc)[W / 32], int i,
                                         int p, int qc, int jb, int n, int d0,
                                         int r, bool act, bool track,
                                         int match, int mismatch, int gapo,
                                         int gape) {
  constexpr int L = W / 32;
  // lane d+1 of the previous row, across the thread edge
  int h_nb = __shfl_down_sync(FULL, h[0], 1);
  int f_nb = __shfl_down_sync(FULL, f[0], 1);
  if (r == 31) {
    h_nb = NEG;
    f_nb = NEG;
  }
  int v[L], pl[L], fcur[L], diag[L];
  bool fext[L], valid[L];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int h_up = (k + 1 < L) ? h[k + 1] : h_nb;
    const int f_up = (k + 1 < L) ? f[k + 1] : f_nb;
    // max(F', H' - gapo) and its tie bit in one DPX instruction
    const int fm = __vibmax_s32(f_up, h_up - gapo, &fext[k]);
    fcur[k] = __viaddmax_s32(fm, -gape, NEG);
    diag[k] = __viaddmax_s32(h[k], (qc == tc[k]) ? match : -mismatch, NEG);
    valid[k] = FAST || (unsigned)(jb + k) <= (unsigned)n;  // 0 <= j <= n
    const int hv = max(diag[k], fcur[k]);
    v[k] = (valid[k] ? hv : NEG) + (d0 + k) * gape;
    pl[k] = (k == 0) ? v[0] : max(pl[k - 1], v[k]);
  }
  // exclusive prefix max of V: the thread maxima scanned over the warp,
  // then one max per lane with the local prefix
  int x = pl[L - 1];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (r >= o) x = max(x, y);
  }
  int texcl = __shfl_up_sync(FULL, x, 1);
  if (r == 0) texcl = NEG;
  int pex[L];
  bool cbit[L];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    pex[k] = (k == 0) ? texcl : max(texcl, pl[k - 1]);
    cbit[k] = v[k] <= pex[k];
  }
  bool eb = __shfl_up_sync(FULL, (int)cbit[L - 1], 1) != 0;
  if (r == 0) eb = false;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int d = d0 + k;
    const bool e_ext = (k == 0) ? eb : cbit[k - 1];
    // 1 <= j <= n
    const bool ve = FAST || (unsigned)(jb + k - 1) < (unsigned)n;
    const int e_cur = ve ? __viaddmax_s32(pex[k], -(d * gape + gapo), NEG)
                         : NEG;
    const int dm = valid[k] ? diag[k] : NEG;
    const int fm = valid[k] ? fcur[k] : NEG;
    bool no_e, no_f;  // priority diag > E > F
    const int he = __vibmax_s32(dm, e_cur, &no_e);
    const int hh = __vibmax_s32(he, fm, &no_f);
    const int src = no_f ? (no_e ? 0 : 1) : 2;
    if (FAST || (valid[k] && act))
      word[k] |= (src | (e_ext ? 4 : 0) | (fext[k] ? 8 : 0)) << (8 * p);
    if (track && hh > bls[k]) {  // strict: earliest row
      bls[k] = hh;
      blr[k] = i;
    }
    h[k] = hh;
    f[k] = fm;
  }
}

template <int W>
__global__ void __launch_bounds__(32)
kernel(const int32_t* __restrict__ q, const int32_t* __restrict__ t_win,
       const int32_t* __restrict__ m_len, const int32_t* __restrict__ n_len,
       const int32_t* __restrict__ lo_arr, const int32_t* __restrict__ zdrop,
       const int32_t* __restrict__ order, int* __restrict__ next,
       int32_t* __restrict__ dirs32, int32_t* __restrict__ h_last,
       int32_t* __restrict__ best, int B, int M, int match, int mismatch,
       int gapo, int gape) {
  constexpr int L = W / 32;  // lanes per thread
  static_assert(L % 4 == 0, "a thread stores its lanes as int4 words");
  extern __shared__ uint8_t win[];  // q[0, M), t_win[0, M+W)
  const int r = threadIdx.x;
  const int d0 = r * L;             // first lane this thread owns
  uint8_t* qs = win;
  uint8_t* ts = win + M;

  for (;;) {
    int idx = 0;
    if (r == 0) idx = atomicAdd(next, 1);
    idx = __shfl_sync(FULL, idx, 0);
    if (idx >= B) break;
    const int b = order[idx];
    const int m = m_len[b];
    const int n = n_len[b];
    const int lo = lo_arr[b];
    const int zd = zdrop[b];
    __syncwarp();  // the previous instance's windows are read
    stage(qs, q + (size_t)b * M, M, 4u, r);
    stage(ts, t_win + (size_t)b * (M + W), M + W, 5u, r);
    __syncwarp();
    int32_t* db = dirs32 + (size_t)b * (M / 4) * W + d0;
    int32_t* hb = h_last + (size_t)b * W + d0;

    // row 0: cells (0, j), j = lo + d
    int h[L], f[L], tc[L], bls[L], blr[L];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int j0 = lo + d0 + k;
      h[k] = (j0 == 0) ? 0
                       : ((j0 >= 1 && j0 <= n) ? -(gapo + j0 * gape) : NEG);
      f[k] = NEG;
      bls[k] = h[k];  // per-lane best score
      blr[k] = 0;     // earliest row reaching it
      tc[k] = ts[d0 + k];
    }
    if (m == 0) store4<L>(hb, h);
    bool alive = true;  // uniform over the warp

    for (int i0 = 0; i0 < m; i0 += 4) {
      const uint32_t q4 = *reinterpret_cast<const uint32_t*>(qs + i0);
      int tnext[4];  // the top lane's target codes of rows i0+2 .. i0+5
#pragma unroll
      for (int p = 0; p < 4; ++p) tnext[p] = ts[i0 + d0 + L + p];
      int word[L];
#pragma unroll
      for (int k = 0; k < L; ++k) word[k] = 0;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int i = i0 + p + 1;
        const bool act = i <= m;
        const bool track = alive && act;
        const int qc = (int)((q4 >> (8 * p)) & 0xffu);
        const int jb = i + lo + d0;  // j of the thread's first lane
        // uniform over the warp: the whole row is inside the band
        if (act && i + lo >= 1 && i + lo + W - 1 <= n)
          row_step<W, true>(h, f, bls, blr, word, tc, i, p, qc, jb, n, d0, r,
                            act, track, match, mismatch, gapo, gape);
        else
          row_step<W, false>(h, f, bls, blr, word, tc, i, p, qc, jb, n, d0,
                             r, act, track, match, mismatch, gapo, gape);
        if (i == m) {
          int hl[L];
#pragma unroll
          for (int k = 0; k < L; ++k) hl[k] = alive ? h[k] : NEG;
          store4<L>(hb, hl);
        }
        if ((i & (ZDROP_GROUP - 1)) == 0) {
          int cur = h[0], bb = bls[0];
#pragma unroll
          for (int k = 1; k < L; ++k) {
            cur = max(cur, h[k]);
            bb = max(bb, bls[k]);
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            cur = max(cur, __shfl_xor_sync(FULL, cur, o));
            bb = max(bb, __shfl_xor_sync(FULL, bb, o));
          }
          if (act && zd > 0 && cur < bb - zd) alive = false;
        }
        // target codes of row i + 1: lane d takes lane d+1's
#pragma unroll
        for (int k = 0; k + 1 < L; ++k) tc[k] = tc[k + 1];
        tc[L - 1] = tnext[p];
      }
      store4<L>(db + (size_t)(i0 >> 2) * W, word);
    }

    // best cell: max score, then smallest row, then smallest lane, as
    // one 64-bit key (score + 2^29 < 2^30, row < 2^13, lane < 2^8)
    long long key = -1;
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const long long kk = ((long long)(bls[k] - NEG) << 21) |
                           ((long long)(8191 - blr[k]) << 8) |
                           (long long)(255 - (d0 + k));
      key = kk > key ? kk : key;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const long long kk = __shfl_xor_sync(FULL, key, o);
      key = kk > key ? kk : key;
    }
    if (r == 0) {
      best[(size_t)b * 3 + 0] = (int)(key >> 21) + NEG;
      best[(size_t)b * 3 + 1] = 8191 - (int)((key >> 8) & 8191);
      best[(size_t)b * 3 + 2] = 255 - (int)(key & 255);
    }
  }
}

// one warp per block; one block per instance, at most what the SMs hold
// at once
template <int W>
int launch(const int32_t* q, const int32_t* t_win, const int32_t* m_len,
           const int32_t* n_len, const int32_t* lo, const int32_t* zdrop,
           const int32_t* order, int* next, int32_t* dirs32,
           int32_t* h_last, int32_t* best, int B, int M, int match,
           int mismatch, int gapo, int gape, cudaStream_t s) {
  const size_t smem = (size_t)(2 * M + W);
  int dev = 0, nsm = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel<W>, 32,
                                                smem);
  const int cap = nsm * (per_sm > 0 ? per_sm : 1);
  cudaMemsetAsync(next, 0, sizeof(int), s);
  kernel<W><<<B < cap ? B : cap, 32, smem, s>>>(
      q, t_win, m_len, n_len, lo, zdrop, order, next, dirs32, h_last, best,
      B, M, match, mismatch, gapo, gape);
  return (int)cudaGetLastError();
}

}  // namespace row_dp

extern "C" int lamsa_banded_sw_row(const int32_t* q, const int32_t* t_win,
                                   const int32_t* m_len, const int32_t* n_len,
                                   const int32_t* lo, const int32_t* zdrop,
                                   const int32_t* order, int* next,
                                   int32_t* dirs32, int32_t* h_last,
                                   int32_t* best, int B, int M, int W,
                                   int match, int mismatch, int gapo,
                                   int gape, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (W == 128)
    return row_dp::launch<128>(q, t_win, m_len, n_len, lo, zdrop, order,
                               next, dirs32, h_last, best, B, M, match,
                               mismatch, gapo, gape, s);
  if (W == 256)
    return row_dp::launch<256>(q, t_win, m_len, n_len, lo, zdrop, order,
                               next, dirs32, h_last, best, B, M, match,
                               mismatch, gapo, gape, s);
  return (int)cudaErrorInvalidValue;
}
