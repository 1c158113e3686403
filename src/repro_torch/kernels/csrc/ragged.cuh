// Ragged grouped matmuls (K3 and its backward with starts): one packed
// buffer of M rows in which expert e owns the rows starts[e] ..
// starts[e] + rows[e], both (E,) int32 on the device.  The host knows M
// and E but not the counts, so a grid along the rows has ceil(M / bm) + E
// tiles, enough for any counts (expert e needs ceil(rows[e] / bm) <=
// rows[e] / bm + 1 of them), and each block finds its own expert and
// tile; the blocks past the last tile exit.  Each source that includes
// this header is rebuilt when it changes (_build.py).
#pragma once

#include <cuda_runtime.h>

namespace {

// Expert e's segment: its first row, clamped into [0, M], and its row
// count, clamped into [0, M - first row].
struct Segment {
  int start, rows;
};

__device__ __forceinline__ Segment segment(const int* rows,
                                           const int* starts, int e, int M) {
  const int s = min(max(starts[e], 0), M);
  return {s, min(max(rows[e], 0), M - s)};
}

// Tile t of the ragged grid, in which the experts hold ceil(rows / bm)
// tiles of bm rows each, in expert order: (expert, first row of the tile
// within the expert's segment), or expert -1 when t lies past the last
// tile.  Warp 0 scans the experts' tile counts 32 at a time (a shuffle
// prefix sum) and stops at the expert holding tile t.  Every thread of
// the block must call it: it ends with a barrier.
__device__ int2 ragged_tile(const int* rows, const int* starts, int E, int M,
                            int bm, int t) {
  __shared__ int2 found;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    if (lane == 0) found = make_int2(-1, 0);
    __syncwarp();
    int base = 0;                     // tiles of the experts already scanned
    for (int e0 = 0; e0 < E && base <= t; e0 += 32) {
      const int e = e0 + lane;
      const int n =
          e < E ? (segment(rows, starts, e, M).rows + bm - 1) / bm : 0;
      int incl = n;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      const int first = base + incl - n;
      if (t >= first && t < first + n) found = make_int2(e, (t - first) * bm);
      base += __shfl_sync(0xffffffffu, incl, 31);
    }
  }
  __syncthreads();
  return found;
}

}  // namespace
