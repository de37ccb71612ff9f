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
// Sources of cell (i, j): diag at lane l of step a-2 (a register), E at
// lane l-1 of step a-1 on even a (lane l on odd a), F at lane l+1 of
// step a-1 on odd a (lane l on even a). Neither E nor F needs a scan,
// unlike the row kernel's in-row prefix max.
//
// One thread block per instance, one thread per lane (V = 64 or 128).
// The instance's q and t window are staged once in shared memory as
// bytes (codes >= 4 mapped so that they never match), and the kernel
// indexes q[i-1] and t_win[j-1-lo] there: the TPU's pre-shifted window
// arrays are not needed. Per step the neighbour's state comes from a
// warp shuffle; lane 0 / lane 31 of each warp read it from shared
// memory, published by the neighbouring warp before the one block
// barrier of the step. Four steps' nibbles are packed into one uint32
// word per lane and stored coalesced to dirs32a[b, (a-1)/4, l]. Each
// instance stops at its own a = m + n; words above are not written.
//
// What bounds it on an H100: the step loop is a serial chain of one
// block barrier and two shuffles per step, so a block is latency-bound;
// throughput comes from many blocks per SM (small blocks, about 2M + W
// bytes of shared memory each). Memory traffic is the direction output
// (one byte per band cell, V lanes x 4 steps per word) plus the windows
// read once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -(1 << 29);
constexpr unsigned FULL = 0xffffffffu;

template <int V>
__global__ void __launch_bounds__(V)
banded_sw_adiag_kernel(const int32_t* __restrict__ q,
                       const int32_t* __restrict__ t_win,
                       const int32_t* __restrict__ m_len,
                       const int32_t* __restrict__ n_len,
                       const int32_t* __restrict__ lo_arr,
                       int32_t* __restrict__ dirs32a,
                       int32_t* __restrict__ h_last, int M, int A4,
                       int match, int mismatch, int gapo, int gape) {
  constexpr int W = 2 * V;
  constexpr int NWARP = V / 32;
  extern __shared__ uint8_t win[];   // q[0, M) then t_win[0, M + W)
  __shared__ int xr_h[NWARP];        // lane 31 -> next warp's lane 0
  __shared__ int xr_e[NWARP];
  __shared__ int xl_h[NWARP];        // lane 0 -> previous warp's lane 31
  __shared__ int xl_f[NWARP];

  const int b = blockIdx.x;
  const int l = threadIdx.x;
  const int lane = l & 31;
  const int warp = l >> 5;
  const int m = m_len[b];
  const int n = n_len[b];
  const int lo = lo_arr[b];
  const int hl = lo >> 1;            // arithmetic shift: lo <= 0
  uint8_t* qs = win;
  uint8_t* ts = win + M;
  const int32_t* qb = q + (size_t)b * M;
  const int32_t* tb = t_win + (size_t)b * (M + W);
  // N (4), sentinels and anything else >= 4 never match: q -> 4, t -> 5
  for (int x = l; x < M; x += V) {
    const int c = qb[x];
    qs[x] = (uint8_t)(((unsigned)c < 4u) ? c : 4);
  }
  for (int x = l; x < M + W; x += V) {
    const int c = tb[x];
    ts[x] = (uint8_t)(((unsigned)c < 4u) ? c : 5);
  }

  // E chain through all-invalid prefixes, and the lane-0 fill that
  // makes the chain equal the spec's exclusive prefix max there
  const int E_DEAD = NEG - gapo - gape;
  const int E_FILL = NEG - gapo + gape;
  int h1 = (l == -hl) ? 0 : NEG;     // step 0: only cell (0, 0)
  int h2 = NEG;
  int e = E_DEAD;
  int f = NEG;
  int ce = NEG;                      // h_last capture, even / odd a
  int co = NEG;
  uint32_t word = 0;
  int32_t* db = dirs32a + (size_t)b * A4 * V;
  const int last = m + n;

  if (lane == 0) {                   // step 1 is odd: F from lane l+1
    xl_h[warp] = h1;
    xl_f[warp] = f;
  }
  __syncthreads();                   // windows staged, step 0 published

  for (int a = 1; a <= last; ++a) {
    const int par = a & 1;
    const int u = a >> 1;
    int h_e, e_s, h_f, f_s;
    if (par == 0) {
      int hu = __shfl_up_sync(FULL, h1, 1);
      int eu = __shfl_up_sync(FULL, e, 1);
      if (lane == 0) {
        hu = (warp == 0) ? NEG : xr_h[warp - 1];
        eu = (warp == 0) ? E_FILL : xr_e[warp - 1];
      }
      h_e = hu;
      e_s = eu;
      h_f = h1;
      f_s = f;
    } else {
      int hd = __shfl_down_sync(FULL, h1, 1);
      int fd = __shfl_down_sync(FULL, f, 1);
      if (lane == 31) {
        hd = (warp == NWARP - 1) ? NEG : xl_h[warp + 1];
        fd = (warp == NWARP - 1) ? NEG : xl_f[warp + 1];
      }
      h_f = hd;
      f_s = fd;
      h_e = h1;
      e_s = e;
    }
    const int hg = h_e - gapo;
    const int ebit = (e_s >= hg && !(par == 0 && l == 0)) ? 1 : 0;
    const int e_new = max(e_s, hg) - gape;   // unclamped chain
    const int hgf = h_f - gapo;
    const int fbit = (f_s >= hgf) ? 1 : 0;
    const int f_new = max(max(hgf, f_s) - gape, NEG);

    const int i = u - hl - l;
    const int j = u + par + hl + l;
    const bool valid = (i >= 1) && (i <= m) && (j >= 0) && (j <= n);
    int s = -mismatch;
    if (valid && qs[i - 1] == ts[j - 1 - lo]) s = match;
    const int diag = max(h2 + s, NEG);

    const int e_m = (valid && j >= 1) ? max(e_new, NEG) : NEG;
    int f_m = valid ? f_new : NEG;
    int h = valid ? diag : NEG;
    int src = 0;                      // priority diag > E > F
    if (e_m > h) src = 1;
    h = max(h, e_m);
    if (f_m > h) src = 2;
    h = max(h, f_m);
    const uint32_t nib =
        valid ? (uint32_t)(src | (ebit << 2) | (fbit << 3)) : 0u;
    word |= nib << (8 * ((a - 1) & 3));
    if ((a & 3) == 0 || a == last) {
      db[(size_t)((a - 1) >> 2) * V + l] = (int32_t)word;
      word = 0;
    }
    if (i == 0) {                     // row-0 cell (0, a) enters here
      h = (a <= n) ? -gapo - a * gape : NEG;
      f_m = NEG;
    }
    if (i == m) {
      if (par == 0) ce = h; else co = h;
    }
    h2 = h1;
    h1 = h;
    e = e_new;
    f = f_m;

    // publish the warp-boundary state step a + 1 needs
    if (par == 1) {                   // a + 1 even: E from lane l-1
      if (lane == 31) {
        xr_h[warp] = h1;
        xr_e[warp] = e;
      }
    } else if (lane == 0) {           // a + 1 odd: F from lane l+1
      xl_h[warp] = h1;
      xl_f[warp] = f;
    }
    __syncthreads();
  }

  int32_t* hb = h_last + (size_t)b * W;
  hb[2 * l] = ce;
  hb[2 * l + 1] = co;
}

}  // namespace

extern "C" int lamsa_banded_sw_adiag(const int32_t* q, const int32_t* t_win,
                                     const int32_t* m_len,
                                     const int32_t* n_len, const int32_t* lo,
                                     int32_t* dirs32a, int32_t* h_last, int B,
                                     int M, int W, int match, int mismatch,
                                     int gapo, int gape, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int A4 = ((2 * M + W + 127) / 128) * 32;   // a_pad(M, W) / 4
  const size_t smem = (size_t)(2 * M + W);         // q + t_win bytes
  if (W == 128) {
    banded_sw_adiag_kernel<64><<<B, 64, smem, s>>>(
        q, t_win, m_len, n_len, lo, dirs32a, h_last, M, A4, match, mismatch,
        gapo, gape);
  } else if (W == 256) {
    banded_sw_adiag_kernel<128><<<B, 128, smem, s>>>(
        q, t_win, m_len, n_len, lo, dirs32a, h_last, M, A4, match, mismatch,
        gapo, gape);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
