// Traceback over antidiagonal-layout direction words, writing the
// compact wire itself: the CUDA counterpart of the Pallas kernel
// lamsa_tpu/ops/banded_sw_adiag.py `_tb_kernel` (entry traceback_adiag,
// pallas_call at :607).
//
// Each instance walks its own cursor from the start cell (si, band
// offset sd) down the antidiagonals: an M step moves to a-2, a D (E
// state) or I (F state) step to a-1. This is the per-instance sequence
// of the TPU's lockstep sweep over descending a, where an instance acts
// only on the sweep step that equals its cursor. Each DP row ends with
// exactly one M or I and may carry a run of D steps; the walk emits
// straight into the wire fields:
//   opbits[b, (r-1)/32] bit (r-1)%32 = 1 for an I step at row r;
//   events: D runs, row-DESCENDING from slot 0 ("topdown"), narrow
//           (row << 5) | cnt packed two per word for M <= 2048, wide
//           (row << 13) | cnt words above;
//   term0 = j at row 0; n_ev = event count, 0xFFFF on overflow (a run
//   longer than the count field, or more events than slots). Writes
//   past the last event word are dropped while the count goes on.
// A lane outside the band reads nibble 0, as the TPU's one-hot select.
//
// What bounds it on an H100: the walk is a serial chain, one direction
// byte per step, each address depending on the byte before. Read from
// device memory that is one round trip (about 530 ns) per step, and the
// direction words of a large chunk do not fit in L2. The work in bytes
// is tiny (one byte per step), so the card's time is the longest
// instance's chain of latencies, and the design shortens that chain:
//   - one warp per instance. A step moves the cursor down one or two
//     antidiagonals and at most one lane sideways, so the bytes of the
//     next steps lie in a tile around it: ADIAG_TILE_ROWS word rows (4
//     antidiagonals each) by ADIAG_TILE_LANES lanes. The warp stages
//     that tile into shared memory with cp.async (16 bytes a thread,
//     rows coalesced) and walks inside it until the cursor leaves it;
//   - two buffers: the tile below is in flight while this one is walked.
//     Tiles are aligned in a, so the next tile's rows are known; its
//     lane origin is a guess from the cursor's drift across the last
//     tile. A wrong guess, or a cursor that leaves the tile sideways, is
//     a blocking reload at the cursor (counted, exact either way; about
//     1 tile in 4000 on ordinary alignments). A clean tile is walked in
//     less than one memory round trip, so the tile is deep (128
//     antidiagonals): one load in flight then covers the walk of the
//     tile before it. Tiles of a few KB owned by one warp need no TMA
//     descriptor or barrier;
//   - even in shared memory a step taken alone costs a dependent chain
//     of about a hundred instructions (address, load, decode, branches),
//     some 600 cycles for a lone warp, so the warp takes the common case
//     32 steps at once: lane k reads the byte of antidiagonal a - 2k in
//     the cursor's lane, one vote finds the first step whose source is
//     not M, the cursor jumps over all M steps before it, and the serial
//     step that follows uses the byte its lane has already read;
//   - the state is uniform over the warp (every lane reads the same
//     shared byte, a broadcast): an instruction costs one issue slot
//     whether one lane or all are active, and no cursor state has to be
//     sent to the other lanes before the next tile is staged;
//   - outputs leave coalesced or from registers: the warp zero-fills
//     opbits and events together, the I bits of 32 rows gather in one
//     register and are stored once, events are stored as whole words.
// The tile constants come from lamsa_tpu_torch/_build.py (WALK_TILES) as
// -D flags; ops/testing.py mirrors this schedule in numpy, and
// chip_smoke.py --tiles times other tile shapes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "walk_tiles.cuh"

#if !defined(ADIAG_TILE_ROWS) || !defined(ADIAG_TILE_LANES) || \
    !defined(ADIAG_TILE_LEFT)
#error "ADIAG_TILE_ROWS / _LANES / _LEFT come from _build.py (WALK_TILES)"
#endif

namespace {

using namespace walk_tiles;

constexpr int TR = ADIAG_TILE_ROWS;     // word rows of a tile
constexpr int TL = ADIAG_TILE_LANES;    // lanes (words) of a tile row
constexpr int LEFT = ADIAG_TILE_LEFT;   // lanes kept left of the cursor
constexpr int TS = TL + 4;              // tile row stride in words: the
                                        // word rows of one lane fall in
                                        // different banks
constexpr int WARPS = 4;                // instances per block

__global__ void __launch_bounds__(32 * WARPS)
    traceback_adiag_kernel(const int32_t* __restrict__ dirs,
                           const int32_t* __restrict__ si_arr,
                           const int32_t* __restrict__ sd_arr,
                           const int32_t* __restrict__ hl_arr,
                           int32_t* __restrict__ opbits,
                           int32_t* __restrict__ events,
                           int32_t* __restrict__ term0_out,
                           int32_t* __restrict__ nev_out,
                           int32_t* __restrict__ dbg, int B, int A4, int V,
                           int NW, int EW, int wide, int e_slots,
                           int vec16) {
  __shared__ __align__(16) int32_t tiles[WARPS][2][TR * TS];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * WARPS + w;
  if (b >= B) return;                   // uniform over the warp
  uint32_t* op = (uint32_t*)opbits + (size_t)b * NW;
  uint32_t* ev = (uint32_t*)events + (size_t)b * EW;
  for (int k = lane; k < NW; k += 32) op[k] = 0;
  for (int k = lane; k < EW; k += 32) ev[k] = 0;
  __syncwarp();                         // lane 0's later stores come after
  const int CMAX = wide ? 8191 : 30;
  const int RSH = wide ? 13 : 5;
  const int A = 4 * A4;
  // byte (a, lane l) of instance b: word ((a-1)/4, l), byte (a-1)%4 of
  // the little-endian int32
  const int32_t* db = dirs + (size_t)b * A4 * V;

  const int si = si_arr[b];
  const int sd = sd_arr[b];
  const int hl = hl_arr[b];
  const int sj = si + 2 * hl + sd;
  const int sa = si + sj;
  int i = si;
  int l = (sd - (sa & 1)) >> 1;
  int mode = 0;                         // 0 H, 1 E (D run), 2 F (I run)
  int pend = 0;                         // D steps of the current row
  int evc = 0;
  int ovf = 0;
  int term0 = (si == 0) ? sj : 0;
  int acur = (si == 0) ? 0 : sa;
  int opk = -1;                         // opbits word gathered in opw
  uint32_t opw = 0;
  uint32_t evw = 0;                     // narrow event word being filled
  int n_stage = 0, n_block = 0;         // tiles staged / of them blocking

  // the D run of `cnt` steps that ends at row `row`: the next event
  auto emit_event = [&](int row, int cnt) {
    const uint32_t val =
        ((uint32_t)(row - 1) << RSH) | (uint32_t)min(cnt, CMAX);
    if (wide) {
      if (evc < EW && lane == 0) ev[evc] = val;
    } else {
      evw = (evc & 1) ? (evw | (val << 16)) : val;
      if ((evc >> 1) < EW && lane == 0) ev[evc >> 1] = evw;
    }
    if (cnt > CMAX || evc >= e_slots) ovf = 1;
    ++evc;
  };

  if (acur >= 1 && acur <= A && i >= 1) {
    int t = ((acur - 1) >> 2) / TR;     // tile of the cursor
    int cur = 0;
    int l_in = l;                       // cursor lane on entering tile t
    int l0c = tile_origin<LEFT>(l);
    int l0n = l0c;
    stage<TR, TL, TS>(tiles[w][0], db, t, l0c, A4, V, vec16, lane);
    cp_async_commit();
    stage<TR, TL, TS>(tiles[w][1], db, t - 1, l0n, A4, V, vec16, lane);
    cp_async_commit();
    n_stage += 1 + (t > 0);
    for (;;) {
      cp_async_wait<1>();               // all but the tile in flight
      __syncwarp();
      const uint8_t* tb = (const uint8_t*)tiles[w][cur];
      const int a_lo = 4 * t * TR + 1;  // lowest antidiagonal of tile t
      int reason;                       // 0 done, 1 below the tile, 2 beside
      for (;;) {
        if (acur < a_lo || i < 1) {
          reason = (acur >= 1 && i >= 1) ? 1 : 0;
          break;
        }
        const bool in_band = l >= 0 && l < V;
        const int x = l - l0c;
        if (in_band && (x < 0 || x >= TL)) { reason = 2; break; }
        // lane k reads the byte of antidiagonal acur - 2k in the cursor's
        // lane: the M steps that may lie ahead, and the step after them
        const int ak = acur - 2 * lane;
        int byte = 0;
        if (in_band && ak >= a_lo)
          byte = tb[((((ak - 1) >> 2) - t * TR) * TS + x) * 4 +
                    ((ak - 1) & 3)];
        int run = 0;
        if (mode == 0) {
          // the common case, up to 32 steps at once: the steps down to
          // the first whose source is not M are plain M steps (lane
          // kept, no I bit; the first of them ends the row of a pending
          // D run). The step that reaches row 0 is left to the serial
          // path.
          const unsigned mm =
              __ballot_sync(FULL, ak >= a_lo && (byte & 3) == 0);
          run = min(mm == FULL ? 32 : __ffs(~mm) - 1, i - 1);
          if (run > 0) {
            if (pend > 0) {
              emit_event(i, pend);
              pend = 0;
            }
            i -= run;
            acur -= 2 * run;
            if (run == 32 || acur < a_lo) continue;
          }
        }
        // the serial step, on the byte that lane `run` read
        const int a = acur;
        const int nib = __shfl_sync(FULL, byte, run) & 0xF;
        const int src = nib & 3;
        const int eext = (nib >> 2) & 1;
        const int fext = (nib >> 3) & 1;
        const bool isE = (mode == 1) || (mode == 0 && src == 1);
        const bool isF = (mode == 2) || (mode == 0 && src == 2);
        const bool isM = (mode == 0) && (src == 0);
        if (!(isE || isF || isM)) {     // the sweep leaves this cursor behind
          reason = 0;
          break;
        }
        const bool commit = isM || isF; // the row's last step
        const int widx = (i - 1) >> 5;
        if (isF && widx < NW) {
          if (widx != opk) {
            if (opk >= 0 && lane == 0) op[opk] = opw;
            opk = widx;
            opw = 0;
          }
          opw |= 1u << ((i - 1) & 31);
        }
        if (commit && pend > 0) emit_event(i, pend);
        pend = isE ? pend + 1 : 0;
        if ((a & 1) == 0) {
          l -= isE ? 1 : 0;             // even a: D moves to lane l-1
        } else {
          l += isF ? 1 : 0;             // odd a: I moves to lane l+1
        }
        mode = isE ? (eext ? 1 : 0) : (isF ? (fext ? 2 : 0) : 0);
        if (commit) --i;
        const int a2 = a - (isM ? 2 : 1);
        if (commit && i == 0) {
          term0 = a2;                   // j at row 0
          acur = 0;
        } else {
          acur = a2;
        }
      }
      if (reason == 0) break;
      __syncwarp();                     // every lane has left the tile
      if (reason == 1) {
        // the tile below was staged ahead at the guessed origin l0n
        --t;
        cur ^= 1;
        const int drift = l - l_in;
        l_in = l;
        l0c = l0n;
        if (l >= 0 && l < V && (l < l0c || l >= l0c + TL)) {
          cp_async_wait<0>();           // wrong guess: restage at the cursor
          __syncwarp();
          l0c = tile_origin<LEFT>(l);
          stage<TR, TL, TS>(tiles[w][cur], db, t, l0c, A4, V, vec16, lane);
          cp_async_commit();
          ++n_stage;
          ++n_block;
        }
        l0n = tile_origin<LEFT>(l + drift);
        stage<TR, TL, TS>(tiles[w][cur ^ 1], db, t - 1, l0n, A4, V,
                          vec16, lane);
        cp_async_commit();
        n_stage += (t > 0);
      } else {
        // sideways out of the tile: restage it at the cursor; the tile
        // below stays as it was staged
        cp_async_wait<0>();
        __syncwarp();
        l0c = tile_origin<LEFT>(l);
        stage<TR, TL, TS>(tiles[w][cur], db, t, l0c, A4, V, vec16, lane);
        cp_async_commit();
        cp_async_commit();              // an empty group keeps wait<1> right
        ++n_stage;
        ++n_block;
      }
    }
    cp_async_wait<0>();
  }
  if (lane == 0) {
    if (opk >= 0) op[opk] = opw;
    term0_out[b] = term0;
    nev_out[b] = ovf ? 0xFFFF : evc;
    if (dbg) {
      dbg[2 * b] = n_stage;
      dbg[2 * b + 1] = n_block;
    }
  }
}

}  // namespace

// dbg: null, or int32[B, 2] receiving per instance the tiles staged and
// how many of them were blocking reloads (wrong guess or sideways exit).
extern "C" int lamsa_traceback_adiag(const int32_t* dirs32a,
                                     const int32_t* start_i,
                                     const int32_t* start_d,
                                     const int32_t* hl, int32_t* opbits,
                                     int32_t* events, int32_t* term0,
                                     int32_t* n_ev, int32_t* dbg, int B,
                                     int A4, int V, int M, int EW, int wide,
                                     int e_slots, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  const int vec16 = (V % 4 == 0) && ((uintptr_t)dirs32a % 16 == 0);
  const int blocks = (B + WARPS - 1) / WARPS;
  traceback_adiag_kernel<<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
      dirs32a, start_i, start_d, hl, opbits, events, term0, n_ev, dbg, B, A4,
      V, M / 32, EW, wide, e_slots, vec16);
  return (int)cudaGetLastError();
}
