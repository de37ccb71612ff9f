// Traceback over row-layout direction words: the CUDA counterpart of
// the Pallas kernel lamsa_tpu/ops/traceback_pallas.py `_kernel`
// (entry traceback_pallas, pallas_call at :227).
//
// Each instance walks from (start_i, start_d) up to row 0. Every row
// visit emits one optional run of D steps (the E-state chain moving
// left within the row) and exactly one up-step (M: same lane, I:
// lane + 1), so the walk visits each row once. Output per instance:
//   steps[b, r-1] = d_count | op << 16 (op 0 = M, 1 = I, 2 = inactive
//                   for rows above the start cell),
//   term[b, 0]    = j at row 0 (leading D count of the CIGAR),
//   term[b, 1]    = final lane (0 when the walk starts at row 0).
// The D-run count equals the TPU kernel's suffix-AND over the chain
// bits c[y] = is_e[y] | e_ext[y+1] below the seed lane; here it is a
// leftward scan over the staged row, stopping at the first y with
// c[y] == 0.
//
// What bounds it on an H100: the walk is a serial chain, a few
// direction bytes per row, each address depending on the byte before.
// Read from device memory that is one round trip (about 530 ns) per
// row, and the direction words of a large chunk do not fit in L2. The
// work in bytes is tiny, so the card's time is the longest instance's
// chain of latencies, and the design shortens that chain:
//   - one warp per instance. Over ROW_TILE_ROWS word rows (4 DP rows
//     each) the cursor moves right by at most one lane a row and left
//     by its D runs, so the bytes of the next rows lie in a window of
//     ROW_TILE_LANES lanes around it. The warp stages that tile into
//     shared memory with cp.async (16 bytes a thread, rows coalesced)
//     and walks inside it; a 32-lane window reads an eighth (W = 256)
//     or a quarter (W = 128) of the direction words a full-width tile
//     would;
//   - two buffers: the tile above (lower rows) is in flight while this
//     one is walked. Tiles are aligned in rows; the next tile's lane
//     origin is a guess from the cursor's drift across the last tile. A
//     wrong guess, a cursor that leaves the window, or a D run that
//     scans past its left edge (a long deletion) is a blocking reload
//     at the lane needed (counted; about 1 tile in 3000 on ordinary
//     alignments); the scan keeps its count across the reload and the F
//     state carries across rows and tiles, so the result is exact
//     either way. A clean tile is walked in less than one memory round
//     trip, so the tile is deep (128 rows): one load in flight then
//     covers the walk of the tile before it;
//   - even in shared memory a row taken alone costs a dependent chain of
//     about a hundred instructions (address, load, decode, branches),
//     some 600 cycles for a lone warp, so the warp takes the common case
//     32 rows at once: lane k reads the byte of row r - k in the
//     cursor's lane, one vote finds the first row whose source is not M,
//     all rows before it are emitted as M steps in one go, and the
//     serial row that follows uses the byte its lane has already read;
//   - the D run stays a leftward scan, now over shared memory: runs are
//     0-2 lanes on nearly every row that has one, and chunks whose every
//     instance carries a W/2 - 16 base deletion take no longer than
//     ordinary ones (chip_smoke.py --tiles), so a vote over the window
//     has nothing to gain;
//   - the state is uniform over the warp (shared-memory broadcast
//     reads), so lane k keeps the step word of row 32g + k in a register
//     and the warp stores 32 rows of steps as one 128-byte line; the
//     inactive fill above start_i and term are coalesced stores too.
// The tile constants come from lamsa_tpu_torch/_build.py (WALK_TILES) as
// -D flags; ops/testing.py mirrors this schedule in numpy, and
// chip_smoke.py --tiles times other tile shapes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "walk_tiles.cuh"

#if !defined(ROW_TILE_ROWS) || !defined(ROW_TILE_LANES) || \
    !defined(ROW_TILE_LEFT)
#error "ROW_TILE_ROWS / _LANES / _LEFT come from _build.py (WALK_TILES)"
#endif

namespace {

using namespace walk_tiles;

constexpr int OP_M = 0;
constexpr int OP_I = 1;
constexpr int OP_INACTIVE = 2;

constexpr int TR = ROW_TILE_ROWS;       // word rows of a tile
constexpr int TL = ROW_TILE_LANES;      // lanes (words) of a tile row
constexpr int LEFT = ROW_TILE_LEFT;     // lanes kept left of the cursor
constexpr int TS = TL + 4;              // tile row stride in words: the
                                        // word rows of one lane fall in
                                        // different banks
constexpr int WARPS = 4;                // instances per block

// Lane origin of a tile restaged for a D-run scan that needs lanes y
// and y + 1: the window's right end at y + 1 .. y + 4, the rest of it
// to the left, where the scan goes.
__device__ __forceinline__ int scan_origin(int y) {
  return (y + 2 - TL + 3) & ~3;
}

__global__ void __launch_bounds__(32 * WARPS)
    traceback_row_kernel(const int32_t* __restrict__ dirs,
                         const int32_t* __restrict__ lo_arr,
                         const int32_t* __restrict__ si_arr,
                         const int32_t* __restrict__ sd_arr,
                         int32_t* __restrict__ steps,
                         int32_t* __restrict__ term,
                         int32_t* __restrict__ dbg, int B, int M, int W,
                         int vec16) {
  __shared__ __align__(16) int32_t tiles[WARPS][2][TR * TS];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * WARPS + w;
  if (b >= B) return;                   // uniform over the warp
  const int M4 = M / 4;
  // byte (row r >= 1, lane x) of instance b: word ((r-1)/4, x), byte
  // (r-1)%4 of the little-endian int32
  const int32_t* db = dirs + (size_t)b * M4 * W;
  const int lo = lo_arr[b];
  const int si = si_arr[b];
  int d = sd_arr[b];
  int32_t* st = steps + (size_t)b * M;
  // rows above the 32-row group of start_i; that group's own rows above
  // start_i leave with the group's line
  for (int k = (si >= 1 ? ((si - 1) >> 5) + 1 : 0) * 32 + lane; k < M;
       k += 32)
    st[k] = OP_INACTIVE << 16;
  int mystep = OP_INACTIVE << 16;       // step word of row 32g + lane
  int n_stage = 0, n_block = 0;         // tiles staged / of them blocking

  if (si >= 1) {
    int r = si;
    int in_f = 0;
    int scanning = 0;                   // inside a D-run scan of row r
    int y = 0;                          // next lane the scan examines
    int count = 0;
    int t = ((r - 1) >> 2) / TR;        // tile of the cursor
    int cur = 0;
    int d_in = d;                       // cursor lane on entering tile t
    int l0c = tile_origin<LEFT>(d);
    int l0n = l0c;
    stage<TR, TL, TS>(tiles[w][0], db, t, l0c, M4, W, vec16, lane);
    cp_async_commit();
    stage<TR, TL, TS>(tiles[w][1], db, t - 1, l0n, M4, W, vec16, lane);
    cp_async_commit();
    n_stage += 1 + (t > 0);
    for (;;) {
      cp_async_wait<1>();               // all but the tile in flight
      __syncwarp();
      const uint8_t* tb = (const uint8_t*)tiles[w][cur];
      const int r_lo = 4 * t * TR + 1;  // lowest row of tile t
      int reason;           // 0 done, 1 past the tile, 2 lane d, 3 scan lane
      for (;;) {
        if (r < 1) { reason = 0; break; }
        if (r < r_lo) { reason = 1; break; }
        int op, newlane, newf, bx = 0, x = d, bd = 0;
        bool up_known = false;
        if (!scanning) {
          const bool in_band = d >= 0 && d < W;
          const int xd = d - l0c;
          if (in_band && (xd < 0 || xd >= TL)) { reason = 2; break; }
          // lane k reads the byte of row r - k in the cursor's lane: the
          // M steps that may lie ahead, and the row after them
          const int rk = r - lane;
          int byte = 0;
          if (in_band && rk >= r_lo)
            byte = tb[((((rk - 1) >> 2) - t * TR) * TS + xd) * 4 +
                      ((rk - 1) & 3)];
          int run = 0;
          if (!in_f) {
            // the common case, up to 32 rows at once: the rows down to
            // the first whose source is not M are plain M steps (no D
            // run, lane kept), within the 32-row line of step words
            const unsigned mm =
                __ballot_sync(FULL, rk >= r_lo && (byte & 3) == 0);
            const int p = (r - 1) & 31;     // place in the line
            run = min(mm == FULL ? 32 : __ffs(~mm) - 1, p + 1);
            if (run > 0) {
              if (lane <= p && lane > p - run) mystep = OP_M << 16;
              r -= run;
              if (run == p + 1) {
                if (r + lane < M) st[r + lane] = mystep;
                mystep = OP_INACTIVE << 16;
                continue;
              }
              if (r < r_lo) continue;
            }
          }
          // the serial row, on the byte that lane `run` read
          bd = __shfl_sync(FULL, byte, run);
          if (in_f) {
            op = OP_I;
            newlane = d + 1;
            newf = (bd >> 3) & 1;
            count = 0;
            up_known = true;
          } else {
            count = (bd & 3) == 1;
            if (count) {
              scanning = 1;
              y = d - 1;
            } else {
              bx = bd & 0xF;
            }
          }
        }
        // byte of (row r, lane l0c) in the tile
        const uint8_t* row =
            tb + (((r - 1) >> 2) - t * TR) * TS * 4 + ((r - 1) & 3);
        if (scanning) {
          // here 0 <= d < W, so lane y + 1 <= d is inside the band
          bool miss = false;
          while (y >= 0) {
            const int xy = y - l0c;
            if (xy < 0 || xy + 1 >= TL) { miss = true; break; }
            const int is_e = (row[4 * xy] & 3) == 1;
            const int e_up = (row[4 * (xy + 1)] >> 2) & 1;
            if (!(is_e | e_up)) break;
            ++count;
            --y;
          }
          if (miss) { reason = 3; break; }
          scanning = 0;
          x = y;                        // = d - count
          bx = (x >= 0) ? (row[4 * (x - l0c)] & 0xF) : 0;
        }
        if (!up_known) {
          if ((bx & 3) == 0) {
            op = OP_M;
            newlane = x;
            newf = 0;
          } else {
            op = OP_I;
            newlane = x + 1;
            newf = (bx >> 3) & 1;
          }
        }
        const int k = r - 1;
        if ((k & 31) == lane) mystep = count | (op << 16);
        if ((k & 31) == 0) {
          if (k + lane < M) st[k + lane] = mystep;
          mystep = OP_INACTIVE << 16;
        }
        d = newlane;
        in_f = newf;
        --r;
      }
      if (reason == 0) break;
      __syncwarp();                     // every lane has left the tile
      if (reason == 1) {
        // the next tile was staged ahead at the guessed origin l0n
        --t;
        cur ^= 1;
        const int drift = d - d_in;
        d_in = d;
        l0c = l0n;
        if (d >= 0 && d < W && (d < l0c || d >= l0c + TL)) {
          cp_async_wait<0>();           // wrong guess: restage at the cursor
          __syncwarp();
          l0c = tile_origin<LEFT>(d);
          stage<TR, TL, TS>(tiles[w][cur], db, t, l0c, M4, W, vec16, lane);
          cp_async_commit();
          ++n_stage;
          ++n_block;
        }
        l0n = tile_origin<LEFT>(d + drift);
        stage<TR, TL, TS>(tiles[w][cur ^ 1], db, t - 1, l0n, M4, W,
                          vec16, lane);
        cp_async_commit();
        n_stage += (t > 0);
      } else {
        // out of the window within the tile: restage it at the lane
        // needed; the next tile stays as it was staged
        cp_async_wait<0>();
        __syncwarp();
        l0c = (reason == 2) ? tile_origin<LEFT>(d) : scan_origin(y);
        stage<TR, TL, TS>(tiles[w][cur], db, t, l0c, M4, W, vec16, lane);
        cp_async_commit();
        cp_async_commit();              // an empty group keeps wait<1> right
        ++n_stage;
        ++n_block;
      }
    }
    cp_async_wait<0>();
  }
  if (lane < 8)
    term[(size_t)b * 8 + lane] =
        (lane == 0) ? lo + d : ((lane == 1 && si >= 1) ? d : 0);
  if (dbg && lane == 0) {
    dbg[2 * b] = n_stage;
    dbg[2 * b + 1] = n_block;
  }
}

}  // namespace

// dbg: null, or int32[B, 2] receiving per instance the tiles staged and
// how many of them were blocking reloads (wrong guess, cursor out of the
// window, or a D-run scan past its left edge).
extern "C" int lamsa_traceback_row(const int32_t* dirs32, const int32_t* lo,
                                   const int32_t* start_i,
                                   const int32_t* start_d, int32_t* steps,
                                   int32_t* term, int32_t* dbg, int B, int M,
                                   int W, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  const int vec16 = (W % 4 == 0) && ((uintptr_t)dirs32 % 16 == 0);
  const int blocks = (B + WARPS - 1) / WARPS;
  traceback_row_kernel<<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
      dirs32, lo, start_i, start_d, steps, term, dbg, B, M, W, vec16);
  return (int)cudaGetLastError();
}
