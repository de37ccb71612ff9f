// Traceback over antidiagonal-layout direction words, writing the
// compact wire itself: the CUDA counterpart of the Pallas kernel
// lamsa_tpu/ops/banded_sw_adiag.py `_tb_kernel` (entry traceback_adiag,
// pallas_call at :607).
//
// One thread per instance walks its own cursor from the start cell
// (si, band offset sd) down the antidiagonals: an M step moves to a-2,
// a D (E state) or I (F state) step to a-1. This is the per-instance
// sequence of the TPU's lockstep sweep over descending a, where an
// instance acts only on the sweep step that equals its cursor. Each DP
// row ends with exactly one M or I and may carry a run of D steps;
// the thread emits straight into the wire fields:
//   opbits[b, (r-1)/32] bit (r-1)%32 = 1 for an I step at row r;
//   events: D runs, row-DESCENDING from slot 0 ("topdown"), narrow
//           (row << 5) | cnt packed two per word for M <= 2048, wide
//           (row << 13) | cnt words above;
//   term0 = j at row 0; n_ev = event count, 0xFFFF on overflow (a run
//   longer than the count field, or more events than slots). Writes
//   past the last event word are dropped while the count goes on.
// A lane outside the band reads nibble 0, as the TPU's one-hot select.
//
// What bounds it on an H100: every step is a dependent byte load
// (pointer chasing), about one L2 / device-memory round trip per step;
// throughput comes from one thread per instance across the chunk. The
// walk reads only the cells it visits, where the TPU sweep reads a whole
// (G, V) word tile per step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void traceback_adiag_kernel(const uint8_t* __restrict__ dirs,
                                       const int32_t* __restrict__ si_arr,
                                       const int32_t* __restrict__ sd_arr,
                                       const int32_t* __restrict__ hl_arr,
                                       int32_t* __restrict__ opbits,
                                       int32_t* __restrict__ events,
                                       int32_t* __restrict__ term0_out,
                                       int32_t* __restrict__ nev_out, int B,
                                       int A4, int V, int NW, int EW,
                                       int wide, int e_slots) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  uint32_t* op = (uint32_t*)opbits + (size_t)b * NW;
  uint32_t* ev = (uint32_t*)events + (size_t)b * EW;
  for (int k = 0; k < NW; ++k) op[k] = 0;
  for (int k = 0; k < EW; ++k) ev[k] = 0;
  const int CMAX = wide ? 8191 : 30;
  const int RSH = wide ? 13 : 5;
  const int A = 4 * A4;
  // byte (a, lane l) of instance b: word ((a-1)/4, l), byte (a-1)%4 of
  // the little-endian int32
  const uint8_t* db = dirs + (size_t)b * A4 * V * 4;

  const int si = si_arr[b];
  const int sd = sd_arr[b];
  const int hl = hl_arr[b];
  const int sj = si + 2 * hl + sd;
  const int sa = si + sj;
  int i = si;
  int l = (sd - (sa & 1)) >> 1;
  int mode = 0;                       // 0 H, 1 E (D run), 2 F (I run)
  int pend = 0;                       // D steps of the current row
  int evc = 0;
  int ovf = 0;
  int term0 = (si == 0) ? sj : 0;
  int acur = (si == 0) ? 0 : sa;

  while (acur >= 1 && acur <= A && i >= 1) {
    const int a = acur;
    const int nib =
        (l >= 0 && l < V)
            ? db[((size_t)((a - 1) >> 2) * V + l) * 4 + ((a - 1) & 3)] & 0xF
            : 0;
    const int src = nib & 3;
    const int eext = (nib >> 2) & 1;
    const int fext = (nib >> 3) & 1;
    const bool isE = (mode == 1) || (mode == 0 && src == 1);
    const bool isF = (mode == 2) || (mode == 0 && src == 2);
    const bool isM = (mode == 0) && (src == 0);
    if (!(isE || isF || isM)) break;  // the sweep leaves this cursor behind
    const bool commit = isM || isF;   // the row's last step
    if (isF && ((i - 1) >> 5) < NW) op[(i - 1) >> 5] |= 1u << ((i - 1) & 31);
    if (commit && pend > 0) {
      const uint32_t val =
          ((uint32_t)(i - 1) << RSH) | (uint32_t)min(pend, CMAX);
      if (wide) {
        if (evc < EW) ev[evc] |= val;
      } else if ((evc >> 1) < EW) {
        ev[evc >> 1] |= val << (16 * (evc & 1));
      }
      if (pend > CMAX || evc >= e_slots) ovf = 1;
      ++evc;
    }
    if (isE) {
      ++pend;
    } else {
      pend = 0;
    }
    const int i2 = i - (commit ? 1 : 0);
    const int a2 = a - (isM ? 2 : 1);
    if ((a & 1) == 0) {
      l -= isE ? 1 : 0;               // even a: D moves to lane l-1
    } else {
      l += isF ? 1 : 0;               // odd a: I moves to lane l+1
    }
    mode = isE ? (eext ? 1 : 0) : (isF ? (fext ? 2 : 0) : 0);
    i = i2;
    if (commit && i2 == 0) {
      term0 = a2;                     // j at row 0
      acur = 0;
    } else {
      acur = a2;
    }
  }
  term0_out[b] = term0;
  nev_out[b] = ovf ? 0xFFFF : evc;
}

}  // namespace

extern "C" int lamsa_traceback_adiag(const int32_t* dirs32a,
                                     const int32_t* start_i,
                                     const int32_t* start_d,
                                     const int32_t* hl, int32_t* opbits,
                                     int32_t* events, int32_t* term0,
                                     int32_t* n_ev, int B, int A4, int V,
                                     int M, int EW, int wide, int e_slots,
                                     void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  traceback_adiag_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)dirs32a, start_i, start_d, hl, opbits, events, term0,
      n_ev, B, A4, V, M / 32, EW, wide, e_slots);
  return (int)cudaGetLastError();
}
