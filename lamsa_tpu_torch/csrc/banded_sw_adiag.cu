// Global-only banded affine-gap DP in antidiagonal order: the CUDA
// counterpart of the Pallas kernel lamsa_tpu/ops/banded_sw_adiag.py
// `_kernel` (entry banded_sw_adiag_pre, pallas_call at :375). No zdrop
// and no best cell: global gap fills need only the direction nibbles
// and the H row at i == m.
//
// Layout: step a holds every band cell with i + j == a. With lo even
// and hl = lo >> 1, lane l of step a holds d = 2l + (a & 1), so
// V = W / 2 lanes cover the band, and
//   i = (a >> 1) - hl - l,   j = (a >> 1) + (a & 1) + hl + l.
// Sources of cell (i, j): diag at lane l of step a-2, E at lane l-1 of
// step a-1 on even a (lane l on odd a), F at lane l+1 of step a-1 on
// odd a (lane l on even a). Neither E nor F needs a scan, unlike the
// row kernel's in-row prefix max. Four steps' nibbles are packed into
// one uint32 word per lane, stored to dirs32a[b, (a-1)/4, l]; words
// above an instance's a = m + n are not written.
//
// What bounds it on an H100: about 12 integer operations per band cell,
// so the card's floor is its INT32 issue rate; memory is one direction
// byte per cell plus the windows read once. But every instance is a
// serial chain of m + n steps, and a chunk of the main path holds fewer
// instances than the card holds warps, so what a launch costs is the
// latency of one step times the longest m + n.
//
// Design, against that latency: one warp per instance, each thread
// owning L = V / 32 consecutive lanes in registers (H of the last two
// steps, E, F, the h_last captures, query and target codes, packed
// direction word), one warp per block, so the step loop has no block
// barrier and no shared-memory publish. E from lane l-1 (even steps) and
// F from lane l+1 (odd steps) come from the thread's own registers
// except at its edge lane: one shuffle pair per step. The instance's q
// and t window are staged once into shared memory as bytes (codes >= 4
// mapped so that they never match; a plain copy loop, not cp.async, as
// in banded_sw_row.cu); the lanes' query codes move up one lane every
// odd step and their target codes down one lane every even step, each
// fed by a guarded shared byte read ahead once per four steps, so the
// loop reads no device memory. Each gap source's max and tie bit is one
// Hopper DPX instruction (__vibmax_s32), as is each add-then-max
// (__viaddmax_s32). Warps are persistent and take instances longest
// first from an atomic counter, as in banded_sw_row.cu. L = V / 32 (one
// warp per instance) won against more instances per warp when measured
// (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace adiag_dp {

constexpr int NEG = -(1 << 29);
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint32_t pack4(int4 v, unsigned bad) {
  const unsigned x = ((unsigned)v.x < 4u) ? (unsigned)v.x : bad;
  const unsigned y = ((unsigned)v.y < 4u) ? (unsigned)v.y : bad;
  const unsigned z = ((unsigned)v.z < 4u) ? (unsigned)v.z : bad;
  const unsigned w = ((unsigned)v.w < 4u) ? (unsigned)v.w : bad;
  return x | (y << 8) | (z << 16) | (w << 24);
}

__device__ __forceinline__ void stage(uint8_t* dst, const int32_t* src,
                                      int count, unsigned bad, int r) {
  for (int x = 4 * r; x < count; x += 4 * 32)
    *reinterpret_cast<uint32_t*>(dst + x) =
        pack4(*reinterpret_cast<const int4*>(src + x), bad);
}

// N ints (a multiple of 2) to 8- or 16-byte aligned p
template <int N>
__device__ __forceinline__ void store_ints(int32_t* p, const int* v) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N; k += 4)
      *reinterpret_cast<int4*>(p + k) =
          make_int4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < N; k += 2)
      *reinterpret_cast<int2*>(p + k) = make_int2(v[k], v[k + 1]);
  }
}

// One antidiagonal step a of one instance for the thread's L lanes;
// PAR = a & 1. FAST: every lane of the warp holds a cell with
// 1 <= i < m and 1 <= j <= n, so the validity selects, the row-0 entry
// and the h_last capture drop out; the slow path handles the band's ends.
template <int V, int PAR, bool FAST, int L = V / 32>
__device__ __forceinline__ void adiag_step(
    int (&h1)[L], int (&h2)[L], int (&e)[L], int (&f)[L], int (&ce)[L],
    int (&co)[L], int (&word)[L], const int (&qc)[L], const int (&tc)[L],
    int a, int p, int ib, int jb, int m, int n, int r, int match,
    int mismatch, int gapo, int gape, int e_fill) {
  int nb_h, nb_x;                 // the edge lane's neighbour
  if (PAR == 0) {                 // E from lane l-1
    nb_h = __shfl_up_sync(FULL, h1[L - 1], 1);
    nb_x = __shfl_up_sync(FULL, e[L - 1], 1);
    if (r == 0) {
      nb_h = NEG;
      nb_x = e_fill;
    }
  } else {                        // F from lane l+1
    nb_h = __shfl_down_sync(FULL, h1[0], 1);
    nb_x = __shfl_down_sync(FULL, f[0], 1);
    if (r == 31) {
      nb_h = NEG;
      nb_x = NEG;
    }
  }
  int hn[L], en[L], fn[L];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    int h_e, e_s, h_f, f_s;
    if (PAR == 0) {
      h_e = (k > 0) ? h1[k - 1] : nb_h;
      e_s = (k > 0) ? e[k - 1] : nb_x;
      h_f = h1[k];
      f_s = f[k];
    } else {
      h_f = (k + 1 < L) ? h1[k + 1] : nb_h;
      f_s = (k + 1 < L) ? f[k + 1] : nb_x;
      h_e = h1[k];
      e_s = e[k];
    }
    // max and tie bit of each gap source in one DPX instruction
    bool ebit, fbit;
    const int e_new = __vibmax_s32(e_s, h_e - gapo, &ebit) - gape;
    if (PAR == 0 && k == 0 && r == 0) ebit = false;  // lane 0
    const int f_new =
        __viaddmax_s32(__vibmax_s32(f_s, h_f - gapo, &fbit), -gape, NEG);
    const int i = ib - k;
    const int j = jb + k;
    // 1 <= i <= m and 0 <= j <= n
    const bool valid = FAST || ((unsigned)(i - 1) < (unsigned)m &&
                                (unsigned)j <= (unsigned)n);
    const int s = (valid && qc[k] == tc[k]) ? match : -mismatch;
    const int diag = __viaddmax_s32(h2[k], s, NEG);
    const int e_m = (FAST || (valid && j >= 1)) ? max(e_new, NEG) : NEG;
    int f_m = valid ? f_new : NEG;
    bool no_e, no_f;              // priority diag > E > F
    const int he = __vibmax_s32(valid ? diag : NEG, e_m, &no_e);
    int h = __vibmax_s32(he, f_m, &no_f);
    const int src = no_f ? (no_e ? 0 : 1) : 2;
    if (valid)
      word[k] |= (src | (ebit ? 4 : 0) | (fbit ? 8 : 0)) << (8 * p);
    if (!FAST) {
      if (i == 0) {               // row-0 cell (0, a) enters here
        h = (a <= n) ? -gapo - a * gape : NEG;
        f_m = NEG;
      }
      if (i == m) {
        if (PAR == 0)
          ce[k] = h;
        else
          co[k] = h;
      }
    }
    hn[k] = h;
    en[k] = e_new;
    fn[k] = f_m;
  }
#pragma unroll
  for (int k = 0; k < L; ++k) {
    h2[k] = h1[k];
    h1[k] = hn[k];
    e[k] = en[k];
    f[k] = fn[k];
  }
}

template <int V>
__global__ void __launch_bounds__(32)
kernel(const int32_t* __restrict__ q, const int32_t* __restrict__ t_win,
       const int32_t* __restrict__ m_len, const int32_t* __restrict__ n_len,
       const int32_t* __restrict__ lo_arr, const int32_t* __restrict__ order,
       int* __restrict__ next, int32_t* __restrict__ dirs32a,
       int32_t* __restrict__ h_last, int B, int M, int A4, int match,
       int mismatch, int gapo, int gape) {
  constexpr int W = 2 * V;
  constexpr int L = V / 32;  // lanes per thread
  static_assert(L % 2 == 0, "a thread stores its lanes as int2 words");
  extern __shared__ uint8_t win[];  // q[0, M), t_win[0, M+W)
  const int r = threadIdx.x;
  const int l0 = r * L;             // first lane this thread owns
  uint8_t* qs = win;
  uint8_t* ts = win + M;
  // E chain through all-invalid prefixes, and the lane-0 fill that
  // makes the chain equal the spec's exclusive prefix max there
  const int E_DEAD = NEG - gapo - gape;
  const int E_FILL = NEG - gapo + gape;

  for (;;) {
    int idx = 0;
    if (r == 0) idx = atomicAdd(next, 1);
    idx = __shfl_sync(FULL, idx, 0);
    if (idx >= B) break;
    const int b = order[idx];
    const int m = m_len[b];
    const int n = n_len[b];
    const int hl = lo_arr[b] >> 1;  // arithmetic: lo <= 0
    __syncwarp();  // the previous instance's windows are read
    stage(qs, q + (size_t)b * M, M, 4u, r);
    stage(ts, t_win + (size_t)b * (M + W), M + W, 5u, r);
    __syncwarp();
    const int last = m + n;
    int32_t* db = dirs32a + (size_t)b * A4 * V + l0;

    // step 0 holds only cell (0, 0); codes for step 1 (u = 0, odd):
    // q index u - hl - l - 1, t index u + (a & 1) - hl + l - 1
    int h1[L], h2[L], e[L], f[L], ce[L], co[L], qc[L], tc[L];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int l = l0 + k;
      h1[k] = (l == -hl) ? 0 : NEG;
      h2[k] = NEG;
      e[k] = E_DEAD;
      f[k] = NEG;
      ce[k] = NEG;  // h_last captures at i == m, even / odd a
      co[k] = NEG;
      const int xq = -hl - l - 1;
      const int xt = l - hl;
      qc[k] = ((unsigned)xq < (unsigned)M) ? qs[xq] : 4;
      tc[k] = ((unsigned)xt < (unsigned)(M + W)) ? ts[xt] : 5;
    }

    for (int a0 = 0; a0 < last; a0 += 4) {
      // the edge lanes' codes for steps a0+2 .. a0+5, read ahead: q after
      // the two odd steps, t after the two even ones
      const int u0 = a0 >> 1;
      int qn[2], tn[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int xq = u0 + x - hl - l0;
        const int xt = u0 + x + 1 - hl + l0 + L - 1;
        qn[x] = ((unsigned)xq < (unsigned)M) ? qs[xq] : 4;
        tn[x] = ((unsigned)xt < (unsigned)(M + W)) ? ts[xt] : 5;
      }
      int word[L];
#pragma unroll
      for (int k = 0; k < L; ++k) word[k] = 0;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int a = a0 + p + 1;
        const int par = (p & 1) ^ 1;  // a0 is a multiple of 4
        const int u = a >> 1;
        const int ib = u - hl - l0;   // i of the thread's first lane
        const int jb = u + par + hl + l0;
        // every cell of the warp lies inside the instance this step
        const bool fast = __all_sync(
            FULL, ib - L + 1 >= 1 && ib <= m - 1 && jb >= 1 &&
                      jb + L - 1 <= n);
#define STEP_(P, F)                                                     \
  adiag_step<V, P, F>(h1, h2, e, f, ce, co, word, qc, tc, a, p, ib, jb, \
                      m, n, r, match, mismatch, gapo, gape, E_FILL)
        if (par == 0) {
          if (fast) STEP_(0, true); else STEP_(0, false);
        } else {
          if (fast) STEP_(1, true); else STEP_(1, false);
        }
#undef STEP_
        if (par == 1) {
          // step a + 1 is even, u + 1: lane l takes lane l-1's q code
#pragma unroll
          for (int k = L - 1; k > 0; --k) qc[k] = qc[k - 1];
          qc[0] = qn[p >> 1];
        } else {
          // step a + 1 is odd, same u: lane l takes lane l+1's t code
#pragma unroll
          for (int k = 0; k + 1 < L; ++k) tc[k] = tc[k + 1];
          tc[L - 1] = tn[p >> 1];
        }
      }
      store_ints<L>(db + (size_t)(a0 >> 2) * V, word);
    }

    int hv[2 * L];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      hv[2 * k] = ce[k];
      hv[2 * k + 1] = co[k];
    }
    store_ints<2 * L>(h_last + (size_t)b * W + 2 * l0, hv);
  }
}

// one warp per block; one block per instance, at most what the SMs hold
// at once
template <int V>
int launch(const int32_t* q, const int32_t* t_win, const int32_t* m_len,
           const int32_t* n_len, const int32_t* lo, const int32_t* order,
           int* next, int32_t* dirs32a, int32_t* h_last, int B, int M,
           int match, int mismatch, int gapo, int gape, cudaStream_t s) {
  constexpr int W = 2 * V;
  const int A4 = ((2 * M + W + 127) / 128) * 32;  // a_pad(M, W) / 4
  const size_t smem = (size_t)(2 * M + W);
  int dev = 0, nsm = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel<V>, 32,
                                                smem);
  const int cap = nsm * (per_sm > 0 ? per_sm : 1);
  cudaMemsetAsync(next, 0, sizeof(int), s);
  kernel<V><<<B < cap ? B : cap, 32, smem, s>>>(
      q, t_win, m_len, n_len, lo, order, next, dirs32a, h_last, B, M, A4,
      match, mismatch, gapo, gape);
  return (int)cudaGetLastError();
}

}  // namespace adiag_dp

extern "C" int lamsa_banded_sw_adiag(const int32_t* q, const int32_t* t_win,
                                     const int32_t* m_len,
                                     const int32_t* n_len, const int32_t* lo,
                                     const int32_t* order, int* next,
                                     int32_t* dirs32a, int32_t* h_last, int B,
                                     int M, int W, int match, int mismatch,
                                     int gapo, int gape, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (W == 128)
    return adiag_dp::launch<64>(q, t_win, m_len, n_len, lo, order, next,
                                dirs32a, h_last, B, M, match, mismatch, gapo,
                                gape, s);
  if (W == 256)
    return adiag_dp::launch<128>(q, t_win, m_len, n_len, lo, order, next,
                                 dirs32a, h_last, B, M, match, mismatch,
                                 gapo, gape, s);
  return (int)cudaErrorInvalidValue;
}
