// Prim's minimum spanning tree over a dense (S, S) float32 matrix, every step
// in one launch, for Hopper (sm_90a).
//
// prim_dense  replaces no TPU kernel.  The reference's Prim
//   (src/repro/core/mst.py prim_dense) is a lax.fori_loop, which XLA runs as
//   one while loop on the TPU.  The port's eager loop (core/mst.py) launches
//   ~15 small kernels a step, S - 1 steps a query: ~15,000 launches at the
//   paper's |S| = 1024, and the card idles between them.
//   Bound: the chain of S - 1 dependent steps.  Each step is a lexicographic
//   (weight, id) argmin over the vertices outside the tree, then a read of
//   the winner's row; the next step needs both.  The S*S*4 bytes are read
//   once (4 MB at S = 1024: ~1.3 us at 3.35 TB/s, from L2), so a step costs
//   what its reduction and one row read cost in latency, ~1 us.
//   Design: each thread owns K vertices and keeps their best weight, the
//   tree vertex it came from and an in-tree bit in registers.  A step folds
//   the thread's K candidates, then each warp's 32 with two redux.sync (the
//   least weight key, then the least id at that key), then the block's warps
//   through shared memory behind one __syncthreads (double-buffered by the
//   step's parity, so no second barrier is needed before the next step's
//   writes).  Every warp reduces the warps' results itself, so the winner
//   reaches every thread without a broadcast.  The threads then read the
//   winner's row, coalesced, and update the entries they own.  One block
//   holds up to 10,240 vertices: 1,024 threads owning up to 8 each, then
//   640 threads owning 16 (the registers of 16 vertices allow no more
//   threads; at 1,024 they spill).  Above one block's reach (the wrapper
//   picks the count from S) the vertices are split over a thread-block
//   cluster of up to 16 blocks: each block's
//   winner goes to its shared memory, cluster.sync() publishes it, and every
//   warp reads the C winners through distributed shared memory.  The number
//   of blocks changes where rows are read, never the order rule.
//
// Exactness: only comparisons, no arithmetic.  The next vertex is the least
// (best, id) among the vertices outside the tree (weights keyed in an
// order-preserving u32, -0.0 as +0.0, as torch.argmin takes them equal);
// Prim stops when that weight is not finite (those vertices keep
// parent[v] == v); an entry improves only where the new row is strictly
// less, so ties keep the earlier best_from.  The same rules as the plain
// loop, so parent is the same bit for bit.  Inputs hold no NaN.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int K16_THREADS = 640;  // threads of a block whose threads own 16 vertices
constexpr int MAX_CLUSTER = 16;
constexpr uint32_t NONE = 0xffffffffu;  // key and id of "no candidate"
constexpr unsigned FULL = 0xffffffffu;

// Order-preserving map of a float to u32 (a < b  <=>  key(a) < key(b)).
__device__ __forceinline__ uint32_t key_of(float x) {
  const uint32_t u = __float_as_uint(__fadd_rn(x, 0.0f));  // -0.0 -> +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// One template per count K of vertices a thread owns (1, 2, 4, 8, 16): the
// arrays stay in registers.  Block b of the cluster owns [b*L, min(S, b*L+L)).
template <int K>
__global__ void __launch_bounds__(K == 16 ? K16_THREADS : MAX_THREADS, 1)
    prim_dense_kernel(const float* __restrict__ w, int32_t* __restrict__ parent, int S, int L) {
  __shared__ uint32_t warp_k[2][32], warp_id[2][32];
  __shared__ uint32_t block_k[2], block_id[2];
  const int T = blockDim.x;
  const int C = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = T >> 5;
  const int lo = blockIdx.x * L;
  const int hi = min(S, lo + L);

  float best[K];
  int32_t from[K];
  uint32_t in_tree = 0;  // bit j: vertex lo + threadIdx.x + j*T is in the tree
  uint32_t k_loc = NONE, id_loc = NONE;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int i = lo + threadIdx.x + j * T;
    best[j] = i < hi ? w[i] : INFINITY;
    from[j] = 0;
    if (i == 0) in_tree |= 1u << j;
    if (i < hi && i != 0) {
      const uint32_t k = key_of(best[j]);
      if (k < k_loc) k_loc = k, id_loc = i;
    }
  }

  const uint32_t k_lo = key_of(-FLT_MAX), k_hi = key_of(FLT_MAX);
  int par = 0;
  for (int step = 1; step < S; ++step, par ^= 1) {
    // the thread's candidate -> the warp's -> the block's
    uint32_t k = __reduce_min_sync(FULL, k_loc);
    uint32_t id = __reduce_min_sync(FULL, k_loc == k ? id_loc : NONE);
    if (lane == 0) warp_k[par][warp] = k, warp_id[par][warp] = id;
    __syncthreads();
    k = lane < nwarps ? warp_k[par][lane] : NONE;
    id = lane < nwarps ? warp_id[par][lane] : NONE;
    uint32_t m = __reduce_min_sync(FULL, k);
    id = __reduce_min_sync(FULL, k == m ? id : NONE);
    if (C > 1) {  // the blocks' winners, through distributed shared memory
      cg::cluster_group cluster = cg::this_cluster();
      if (threadIdx.x == 0) block_k[par] = m, block_id[par] = id;
      cluster.sync();
      k = NONE, id = NONE;
      if (lane < C) {
        k = *cluster.map_shared_rank(&block_k[par], lane);
        id = *cluster.map_shared_rank(&block_id[par], lane);
      }
      m = __reduce_min_sync(FULL, k);
      id = __reduce_min_sync(FULL, k == m ? id : NONE);
    }
    if (m < k_lo || m > k_hi) break;  // the least weight is not finite

    // the winner's row, then the owned entries it improves
    const int v = (int)id;
    const float* row = w + (int64_t)v * S;
    float r[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int i = lo + threadIdx.x + j * T;
      r[j] = i < hi ? row[i] : INFINITY;
    }
    k_loc = NONE, id_loc = NONE;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int i = lo + threadIdx.x + j * T;
      if (i == v) in_tree |= 1u << j;
      if (i >= hi || (in_tree >> j) & 1u) continue;
      if (r[j] < best[j]) best[j] = r[j], from[j] = v;
      const uint32_t kk = key_of(best[j]);
      if (kk < k_loc) k_loc = kk, id_loc = i;
    }
  }
  // no block leaves while another may still read its shared memory
  if (C > 1) cg::this_cluster().sync();
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int i = lo + threadIdx.x + j * T;
    if (i < hi) parent[i] = (in_tree >> j) & 1u ? from[j] : i;
  }
}

template <int K>
cudaError_t launch(const float* w, int32_t* parent, int S, int C, int L, int T,
                   cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)C);
  cfg.blockDim = dim3((unsigned)T);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (C > 1) {
    if (C > 8) {
      const cudaError_t e = cudaFuncSetAttribute(
          prim_dense_kernel<K>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return e;
    }
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  const cudaError_t e = cudaLaunchKernelEx(&cfg, prim_dense_kernel<K>, w, parent, S, L);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// w: (S, S) float32, contiguous; parent: (S,) int32; blocks: the cluster's
// size C in [1, 16].  Each block owns L = ceil(S / C) vertices, at most
// 10,240: up to 8 a thread for L <= 8,192, else 16 a thread.
int prim_dense(int device, const void* w, void* parent, int S, int blocks, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (S < 1 || blocks < 1 || blocks > MAX_CLUSTER || blocks > S)
    return (int)cudaErrorInvalidValue;
  const int L = (S + blocks - 1) / blocks;
  int K = 1;
  while (K < 16 && K * MAX_THREADS < L) K *= 2;
  if (K * (K == 16 ? K16_THREADS : MAX_THREADS) < L) return (int)cudaErrorInvalidValue;
  const int T = ((L + K - 1) / K + 31) / 32 * 32;
  const float* wp = static_cast<const float*>(w);
  int32_t* pp = static_cast<int32_t*>(parent);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return (int)launch<1>(wp, pp, S, blocks, L, T, s);
    case 2: return (int)launch<2>(wp, pp, S, blocks, L, T, s);
    case 4: return (int)launch<4>(wp, pp, S, blocks, L, T, s);
    case 8: return (int)launch<8>(wp, pp, S, blocks, L, T, s);
    default: return (int)launch<16>(wp, pp, S, blocks, L, T, s);
  }
}

const char* prim_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
