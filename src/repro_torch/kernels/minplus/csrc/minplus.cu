// Min-plus ELL relaxation for Hopper (sm_90a): the Voronoi-cell hot loop.
//
// For each ELL row r, the lexicographic minimum over slots j of
//     (dist[nbr[r,j]] + wgt[r,j], lab[nbr[r,j]], nbr[r,j])
// where a slot whose candidate is not finite counts as (+inf, IMAX, IMAX).
// dist/wgt are f32 or bf16 (upcast to f32 before the add, rounded to
// nearest as in the plain version: build without --use_fast_math); ids are
// int32.  Outputs are (R,) f32 / i32 / i32, or (B, R) with B query lanes.
// Inputs must hold no NaN and no -inf (distances are >= 0 or +inf, weights
// >= 0 or +inf), so a slot with weight +inf is inert and its gather is
// skipped.  Lex-min is exact and order-free: any slot order, any split of
// the work gives the same triple, bit for bit.
//
// minplus_resident_lanes  replaces src/repro/kernels/minplus/minplus.py
//   minplus_call (Pallas body _kernel, helper _row_lexmin) and, with B > 1
//   lanes, its jax.vmap over B seed sets; an (N,) input is its B = 1 case.
//
//   Bound: device-memory bytes.  A call must stream the ELL (nbr + wgt,
//   8 B a slot: 3.0 GB at RMAT scale 23, K = 32), read each vertex's dist
//   and lab once a lane and write 12 B a row a lane; it does ~2 operations
//   a slot, far below the card's rate.  The gathers are random: a live
//   slot costs at least one 32-byte sector from L2 or device memory.
//
//   What held the first designs back (a warp a row; then a lane axis over
//   (N, B) copies; 5.1x and 14.4x the bound at full width on an H100):
//   - one warp per row made each row a chain of four dependent trips to
//     memory (wgt, then nbr, then dist, then lab) and a 15-step shuffle
//     reduce, with at most 64 rows in flight an SM: latency, not bytes;
//   - dist and lab lived in two arrays, so a live slot cost two gathered
//     sectors; with B lanes, 16 scalar gathers and 120 shuffles a row;
//   - the 3 GB ELL stream went through L2 at normal priority and evicted
//     the dist/lab table the gathers wanted to find there.
//
//   Design now:
//   - one gather a live slot: pack_records_kernel (one pass before each
//     launch, in the wrapper's time) writes dist (as f32 bits) and lab as
//     one 8-byte record per vertex and lane, lane-minor, so the B records
//     of a vertex are adjacent (B > 1 pads the stride to an even lane
//     count, so a thread loads two lanes as one 16-byte vector);
//   - the ELL stream off the critical path: persistent blocks walk row
//     tiles; a producer warp stages each tile's nbr and wgt in shared
//     memory with TMA bulk copies (cp.async.bulk, completing on an
//     mbarrier) into a ring of 2..4 stages, so the next tiles load while
//     this one gathers; the copies carry an L2 evict-first hint;
//   - no shuffles: each consumer thread owns one (row, lane group) item,
//     folds the row's slots from shared memory into register triples, and
//     issues the gathers of U slots before it consumes any of them, so a
//     row waits on ceil(K / U) gather round trips, not 4 K / 32;
//   - the slot order is rotated by the row's index in the tile, so the
//     rows a warp reads hit distinct shared-memory banks (K = 32).
//   Both kernels share this body (the blocked ones too, below): the
//   single one folds one lane a thread from one 8-byte record a vertex (67
//   MB at scale 23, not padded to two lanes), the lane one a lane pair a
//   thread.  A (1, N) lane input
//   launches the single kernel: with its lane counts fixed at compile time
//   it is ~5 % faster than the lane body at B = 1 (runtime division by the
//   pair count a work item).
//   Bulk copies need 16-byte aligned sources and sizes: the wrapper takes
//   nbr and wgt only if they start on 16 bytes, and a tile is a multiple
//   of 8 rows, so every tile but the last starts and ends on 16 bytes (f32
//   and bf16, any K); the producer copies the last tile's ragged tail bytes
//   by hand before it arms the barrier.  Rows too wide for two stages of 8
//   rows in shared memory (K above ~1800 in f32, ~2400 in bf16) get no
//   ring: the consumers read them in place, the same fold from global
//   memory, slower but exact.
//
// minplus_blocked          replaces src/repro/kernels/minplus/minplus.py
//   minplus_blocked_call (Pallas body _blocked_kernel, helper _lex_merge).
//   Same function, same bound.  On the TPU the grid's second axis walked
//   (SB,) source slices in order and lex-merged each into the revisited
//   output tile, so only one slice of dist/lab had to sit in VMEM.  On the
//   H100 the on-chip level a slice must fit is the 50 MB L2.
//
//   What held the first design back (65x its bound at scale 16; about a
//   second a launch at scale 23): every block of 256 rows staged every
//   slice of dist/lab in shared memory and re-read its rows' K slots for
//   every slice, so a launch moved (R/256)*N*8 + (N/SB)*R*K*4 bytes.
//
//   Design now: one launch a source slice, in order, on the caller's
//   stream, each gathering only from its slice.  A slice is a whole number
//   of SB blocks whose packed records (pack_records, 8 B a vertex and lane)
//   fit an L2 budget.  The wrapper's per-graph layout (blocked_layout)
//   holds the live slots (finite weight) sorted by (slice, row): one run of
//   (nbr, wgt) a row that has slots in the slice, with the run's row and
//   its slot offset.  Every row with no live slot has an empty run in the
//   first slice.  A row has at most one run a slice, so a launch has no
//   write conflicts.  The kernel is the resident body over tiles of TR
//   runs: the producer stages a tile's slots (its span aligned out to 8
//   slots; a stage holds the layout's widest tile, which the wrapper
//   measures once) and its run table with bulk copies, evict-first, so a
//   consumer finds all it needs in shared memory; it folds one run (or a
//   run's lane pair) into register triples that start from the row's
//   triple of the slices before (read back) or from the identity (the
//   row's first run), and writes the triple back.  Traffic a call: the
//   live slots and run table once a lane group, each record once a lane,
//   and the output triple written once a run and read once a run after a
//   row's first.  Lanes are folded in groups of the layout's record
//   stride, one launch a (group, slice); a group of one lane launches the
//   single body.  With B lanes each slice more costs B more
//   read-modify-writes of the triples, which at B = 8 outweigh what the L2
//   hits save, so the wrapper gives a lane group one slice (see PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t IMAX = 0x7fffffff;
constexpr int32_t INF_BITS = 0x7f800000;  // +inf as f32 bits
constexpr int MAX_STAGES = 4;
constexpr int MAX_CONSUMERS = 256;       // consumer threads of a block (8 warps)
constexpr int SMEM_HEADER = 128;         // bytes before the first stage: the mbarriers
constexpr size_t MAX_SMEM = 232448;      // shared memory one block can use on Hopper
// Slots whose gathers a thread issues together, for one lane (U1; UB1 in
// the blocked kernel, whose runs are shorter than rows) and for a lane pair
// (U2), and the ring bytes a block aims at: the fastest of the values tried
// at full width on an H100 (see PERF.md).
constexpr int U1 = 16;
constexpr int UB1 = 8;
constexpr int U2 = 8;
constexpr size_t RING_BUDGET = 96 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// (d1, l1, s1) < (d0, l0, s0) lexicographically.
__device__ __forceinline__ bool lex_less(float d1, int32_t l1, int32_t s1, float d0,
                                         int32_t l0, int32_t s0) {
  return d1 < d0 || (d1 == d0 && (l1 < l0 || (l1 == l0 && s1 < s0)));
}

// ---- mbarrier and bulk-copy helpers (PTX, sm_90)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Returns once the phase of parity ``parity`` of ``bar`` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}

// TMA 1-D bulk copy global -> shared, completing ``bytes`` on ``bar``.
// dst, src and bytes must be multiples of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar, uint64_t pol) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(pol)
      : "memory");
}

// ---- records: (dist f32 bits, lab) of G adjacent lanes of one vertex

template <int G>
__device__ __forceinline__ void load_records(const int2* __restrict__ p, int32_t (&d)[G],
                                             int32_t (&l)[G]);

template <>
__device__ __forceinline__ void load_records<1>(const int2* __restrict__ p, int32_t (&d)[1],
                                                int32_t (&l)[1]) {
  const int2 v = __ldg(p);
  d[0] = v.x;
  l[0] = v.y;
}

template <>
__device__ __forceinline__ void load_records<2>(const int2* __restrict__ p, int32_t (&d)[2],
                                                int32_t (&l)[2]) {
  const int4 v = __ldg(reinterpret_cast<const int4*>(p));
  d[0] = v.x;
  l[0] = v.y;
  d[1] = v.z;
  l[1] = v.w;
}

// Folds the K slots of one staged row into G lane triples.  U slots at a
// time: their (nbr, wgt) from shared memory, then all their gathers, then
// the compares, so up to U gathers a thread are in flight together.
template <typename TW, int G, int U>
__device__ __forceinline__ void fold_row(const int32_t* __restrict__ sn,
                                         const TW* __restrict__ sw, int K, int rot,
                                         const int2* __restrict__ rec, int64_t stride,
                                         float (&bd)[G], int32_t (&bl)[G], int32_t (&bs)[G]) {
  for (int j0 = 0; j0 < K; j0 += U) {
    int32_t u[U];
    float w[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      u[i] = 0;
      w[i] = INFINITY;
      if (j0 + i < K) {
        int j = j0 + i + rot;  // rot < K, so one subtraction wraps it
        if (j >= K) j -= K;
        u[i] = sn[j];
        w[i] = to_f32(sw[j]);
      }
    }
    int32_t rd[U][G], rl[U][G];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      if (!isinf(w[i])) {
        load_records<G>(rec + (int64_t)u[i] * stride, rd[i], rl[i]);
      } else {  // padding slot: inert, no gather
#pragma unroll
        for (int g = 0; g < G; ++g) {
          rd[i][g] = INF_BITS;
          rl[i][g] = IMAX;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float c = __fadd_rn(__int_as_float(rd[i][g]), w[i]);
        if (isfinite(c) && lex_less(c, rl[i][g], u[i], bd[g], bl[g], bs[g])) {
          bd[g] = c;
          bl[g] = rl[i][g];
          bs[g] = u[i];
        }
      }
    }
  }
}

// Folds the items of one tile of ``rows`` rows from row ``row0`` on, whose
// nbr and wgt start at sn and sw (the tile's stage in shared memory, or the
// ELL itself): (row, lane group) pairs, row-major, P groups a row of G
// lanes each; group p covers lanes p*G .. p*G + G - 1 (< B).  rec holds
// ``stride`` records a vertex.
template <typename TW, int G>
__device__ __forceinline__ void fold_tile(const int32_t* __restrict__ sn,
                                          const TW* __restrict__ sw, int64_t row0, int rows,
                                          const int2* __restrict__ rec,
                                          float* __restrict__ out_m,
                                          int32_t* __restrict__ out_l,
                                          int32_t* __restrict__ out_s, int64_t R, int K, int B,
                                          int stride, int P, int CT) {
  constexpr int U = G == 1 ? U1 : U2;
  for (int it = threadIdx.x; it < rows * P; it += CT) {
    const int rr = it / P;
    const int p = it - rr * P;
    float bd[G];
    int32_t bl[G], bs[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      bd[g] = INFINITY;
      bl[g] = IMAX;
      bs[g] = IMAX;
    }
    fold_row<TW, G, U>(sn + (int64_t)rr * K, sw + (int64_t)rr * K, K, K ? rr % K : 0,
                       rec + p * G, stride, bd, bl, bs);
    const int64_t r = row0 + rr;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int b = p * G + g;
      if (b < B) {
        const int64_t o = (int64_t)b * R + r;
        out_m[o] = bd[g];
        out_l[o] = bl[g];
        out_s[o] = bs[g];
      }
    }
  }
}

// Issues the bulk copy of ``bytes`` at src into the stage at dst, the
// ragged tail (bytes past the last multiple of 16) by hand; returns the
// bytes the copy completes on ``bar``.  dst and src start on 16 bytes.
__device__ __forceinline__ uint32_t stage_copy(unsigned char* dst, const void* src,
                                               uint32_t bytes, uint64_t* bar, uint64_t pol) {
  const uint32_t bulk = bytes & ~15u;
  const unsigned char* g = static_cast<const unsigned char*>(src);
  for (uint32_t b = bulk; b < bytes; ++b) dst[b] = g[b];
  if (bulk) bulk_load(dst, g, bulk, bar, pol);
  return bulk;
}

// The resident kernels' tiles: tile t is ELL rows [t*TR, t*TR + TR).  A
// stage holds TR*K nbr, then TR*K wgt.
template <typename TW, int G>
struct RowTiles {
  const int32_t* nbr;
  const TW* wgt;
  const int2* rec;
  float* out_m;
  int32_t* out_l;
  int32_t* out_s;
  int64_t R;
  int K, B, stride, P, TR;

  __device__ int64_t count() const { return (R + TR - 1) / TR; }

  __device__ int rows(int64_t t) const { return (int)(R - t * TR < TR ? R - t * TR : TR); }

  // Producer: stages tile t at st; returns the bytes to expect on bar.
  __device__ uint32_t issue(int64_t t, unsigned char* st, uint64_t* bar, uint64_t pol) const {
    const int64_t first = t * TR * K, slots = (int64_t)rows(t) * K;
    const size_t wgt_at = (size_t)TR * K * sizeof(int32_t);
    return stage_copy(st, nbr + first, (uint32_t)(slots * sizeof(int32_t)), bar, pol) +
           stage_copy(st + wgt_at, wgt + first, (uint32_t)(slots * sizeof(TW)), bar, pol);
  }

  // Consumers: folds tile t from its stage st, or in place if st is null.
  __device__ void fold(int64_t t, const unsigned char* st, int CT) const {
    const int64_t row0 = t * TR;
    const int32_t* sn = nbr + row0 * K;
    const TW* sw = wgt + row0 * K;
    if (st) {
      sn = reinterpret_cast<const int32_t*>(st);
      sw = reinterpret_cast<const TW*>(st + (size_t)TR * K * sizeof(int32_t));
    }
    fold_tile<TW, G>(sn, sw, row0, rows(t), rec, out_m, out_l, out_s, R, K, B, stride, P, CT);
  }
};

// The blocked kernels' tiles: tile t is runs [run0 + t*TR, run0 + t*TR + TR)
// of one source slice (see the header).  run_off[j] is run j's first slot,
// run_off[j + 1] its end; run_row[j] its row, or ~row if the row has a run
// in an earlier slice (its triple is then read back and merged).  A stage
// holds the tile's slots, aligned out to 8 (16 bytes of nbr and of bf16
// wgt): ``cap`` nbr, then ``cap`` wgt (cap, from the wrapper, bounds every
// tile's aligned span); then its runs' run_row from a multiple of 4 (TR + 8
// entries) and run_off from a multiple of 2 (TR + 4), so no copy has a
// ragged tail.  The layout pads all four arrays for the aligned ends.
template <typename TW, int G>
struct RunTiles {
  const int32_t* nbr;
  const TW* wgt;
  const int32_t* run_row;
  const int64_t* run_off;
  const int2* rec;
  float* out_m;
  int32_t* out_l;
  int32_t* out_s;
  int64_t run0, nruns, R;
  int B, stride, P, TR, cap;

  __device__ int64_t count() const { return (nruns + TR - 1) / TR; }

  __device__ int runs(int64_t t) const {
    return (int)(nruns - t * TR < TR ? nruns - t * TR : TR);
  }

  __device__ size_t wgt_at() const { return (size_t)cap * sizeof(int32_t); }
  __device__ size_t rows_at() const { return wgt_at() + (size_t)cap * sizeof(TW); }
  __device__ size_t offs_at() const { return rows_at() + (size_t)(TR + 8) * sizeof(int32_t); }

  __device__ uint32_t issue(int64_t t, unsigned char* st, uint64_t* bar, uint64_t pol) const {
    const int64_t j0 = run0 + t * TR, j1 = j0 + runs(t);
    const int64_t first = run_off[j0] & ~(int64_t)7;
    const int64_t slots = ((run_off[j1] + 7) & ~(int64_t)7) - first;
    const int64_t r0 = j0 & ~(int64_t)3, o0 = j0 & ~(int64_t)1;
    return stage_copy(st, nbr + first, (uint32_t)(slots * sizeof(int32_t)), bar, pol) +
           stage_copy(st + wgt_at(), wgt + first, (uint32_t)(slots * sizeof(TW)), bar, pol) +
           stage_copy(st + rows_at(), run_row + r0,
                      (uint32_t)((((j1 + 3) & ~(int64_t)3) - r0) * sizeof(int32_t)), bar, pol) +
           stage_copy(st + offs_at(), run_off + o0,
                      (uint32_t)((((j1 + 2) & ~(int64_t)1) - o0) * sizeof(int64_t)), bar, pol);
  }

  // Folds tile t's (run, lane group) items from its stage st (or in place
  // if st is null); each starts from its row's triple of the earlier
  // slices or from the identity, and writes the triple back.
  __device__ void fold(int64_t t, const unsigned char* st, int CT) const {
    constexpr int U = G == 1 ? UB1 : U2;
    const int64_t j0 = run0 + t * TR;
    const int32_t* rows = run_row + j0;
    const int64_t* offs = run_off + j0;
    const int32_t* sn = nbr;
    const TW* sw = wgt;
    int64_t first = 0;
    if (st) {
      rows = reinterpret_cast<const int32_t*>(st + rows_at()) + (j0 & 3);
      offs = reinterpret_cast<const int64_t*>(st + offs_at()) + (j0 & 1);
      first = offs[0] & ~(int64_t)7;
      sn = reinterpret_cast<const int32_t*>(st);
      sw = reinterpret_cast<const TW*>(st + wgt_at());
    }
    const int n = runs(t);
    for (int it = threadIdx.x; it < n * P; it += CT) {
      const int rr = it / P;
      const int p = it - rr * P;
      const int64_t a = offs[rr];
      const int len = (int)(offs[rr + 1] - a);
      const int32_t code = rows[rr];
      const bool merge = code < 0;
      const int64_t r = merge ? ~code : code;
      float bd[G];
      int32_t bl[G], bs[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int64_t o = (int64_t)(p * G + g) * R + r;
        const bool old = merge && p * G + g < B;
        bd[g] = old ? out_m[o] : INFINITY;
        bl[g] = old ? out_l[o] : IMAX;
        bs[g] = old ? out_s[o] : IMAX;
      }
      fold_row<TW, G, U>(sn + (a - first), sw + (a - first), len, 0, rec + p * G, stride, bd,
                         bl, bs);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int b = p * G + g;
        if (b < B) {
          const int64_t o = (int64_t)b * R + r;
          out_m[o] = bd[g];
          out_l[o] = bl[g];
          out_s[o] = bs[g];
        }
      }
    }
  }
};

// The body all four min-plus kernels share.  Block: CT consumer threads,
// then one producer warp.  Shared memory: full[S], empty[S] mbarriers, then
// S stages of ``stage_bytes``.  Block b walks tiles b, b + grid, ...  S = 0
// (rows too wide for two stages of 8): no ring, the consumers read their
// tiles in place.
template <typename Tiles>
__device__ __forceinline__ void relax_ring(const Tiles& tl, size_t stage_bytes, int S, int CT) {
  const int64_t ntiles = tl.count();
  if (S == 0) {
    if (threadIdx.x >= CT) return;
    for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) tl.fold(t, nullptr, CT);
    return;
  }
  extern __shared__ __align__(128) unsigned char ring[];
  uint64_t* full = reinterpret_cast<uint64_t*>(ring);
  uint64_t* empty = full + MAX_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CT / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CT) {  // producer warp: one thread issues the copies
    if (threadIdx.x != CT) return;
    const uint64_t pol = evict_first_policy();
    int i = 0;
    for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x, ++i) {
      const int s = i % S;
      mbar_wait(&empty[s], ((i / S) & 1) ^ 1);  // the first round passes at once
      // the consumers' reads of this stage come before the copies' writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      // the expected bytes are armed after the copies are issued: the
      // phase cannot complete before this thread's arrival
      unsigned char* st = ring + SMEM_HEADER + s * stage_bytes;
      mbar_arrive_expect_tx(&full[s], tl.issue(t, st, &full[s], pol));
    }
    return;
  }

  int i = 0;
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x, ++i) {
    const int s = i % S;
    mbar_wait(&full[s], (i / S) & 1);
    tl.fold(t, ring + SMEM_HEADER + s * stage_bytes, CT);
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
  }
}

// The stage bytes of a resident launch (tiles of TR rows) and of a blocked
// one (tiles of TR runs spanning at most ``cap`` slots).
__host__ __device__ inline size_t row_stage_bytes(int TR, int K, size_t wgt_size) {
  return (size_t)TR * K * (sizeof(int32_t) + wgt_size);
}

__host__ __device__ inline size_t run_stage_bytes(int TR, int cap, size_t wgt_size) {
  return (size_t)cap * (sizeof(int32_t) + wgt_size) + (TR + 8) * sizeof(int32_t) +
         (TR + 4) * sizeof(int64_t);
}

// One query: (N,) records, one lane.
template <typename TW>
__global__ void __launch_bounds__(MAX_CONSUMERS + 32)
    minplus_resident_kernel(const int32_t* __restrict__ nbr, const TW* __restrict__ wgt,
                            const int2* __restrict__ rec, float* __restrict__ out_m,
                            int32_t* __restrict__ out_l, int32_t* __restrict__ out_s,
                            int64_t R, int K, int TR, int S, int CT) {
  const RowTiles<TW, 1> tl{nbr, wgt, rec, out_m, out_l, out_s, R, K, 1, 1, 1, TR};
  relax_ring(tl, row_stage_bytes(TR, K, sizeof(TW)), S, CT);
}

// B > 1 query lanes: (N, stride) lane-minor records, a lane pair a thread.
template <typename TW>
__global__ void __launch_bounds__(MAX_CONSUMERS + 32)
    minplus_resident_lanes_kernel(const int32_t* __restrict__ nbr,
                                  const TW* __restrict__ wgt, const int2* __restrict__ rec,
                                  float* __restrict__ out_m, int32_t* __restrict__ out_l,
                                  int32_t* __restrict__ out_s, int64_t R, int K, int B,
                                  int stride, int P, int TR, int S, int CT) {
  const RowTiles<TW, 2> tl{nbr, wgt, rec, out_m, out_l, out_s, R, K, B, stride, P, TR};
  relax_ring(tl, row_stage_bytes(TR, K, sizeof(TW)), S, CT);
}

// One source slice of the layout, one lane: runs [run0, run0 + nruns).
template <typename TW>
__global__ void __launch_bounds__(MAX_CONSUMERS + 32)
    minplus_blocked_kernel(const int32_t* __restrict__ nbr, const TW* __restrict__ wgt,
                           const int32_t* __restrict__ run_row,
                           const int64_t* __restrict__ run_off, int64_t run0, int64_t nruns,
                           const int2* __restrict__ rec, float* __restrict__ out_m,
                           int32_t* __restrict__ out_l, int32_t* __restrict__ out_s,
                           int64_t R, int cap, int TR, int S, int CT) {
  const RunTiles<TW, 1> tl{nbr,   wgt,   run_row, run_off, rec, out_m, out_l,
                           out_s, run0,  nruns,   R,       1,   1,     1,
                           TR,    cap};
  relax_ring(tl, run_stage_bytes(TR, cap, sizeof(TW)), S, CT);
}

// One source slice, a group of B > 1 lanes: (N, stride) records, a lane
// pair a thread.
template <typename TW>
__global__ void __launch_bounds__(MAX_CONSUMERS + 32)
    minplus_blocked_lanes_kernel(const int32_t* __restrict__ nbr, const TW* __restrict__ wgt,
                                 const int32_t* __restrict__ run_row,
                                 const int64_t* __restrict__ run_off, int64_t run0,
                                 int64_t nruns, const int2* __restrict__ rec,
                                 float* __restrict__ out_m, int32_t* __restrict__ out_l,
                                 int32_t* __restrict__ out_s, int64_t R, int cap, int B,
                                 int stride, int P, int TR, int S, int CT) {
  const RunTiles<TW, 2> tl{nbr,   wgt,   run_row, run_off, rec, out_m,  out_l,
                           out_s, run0,  nruns,   R,       B,   stride, P,
                           TR,    cap};
  relax_ring(tl, run_stage_bytes(TR, cap, sizeof(TW)), S, CT);
}

// The record table the resident kernels gather from: rec[u * stride + b] =
// (dist[b, u] as f32 bits, lab[b, u]) for b < B, (+inf, IMAX) for the
// padding lane of an odd B.  Stride 1: one thread a vertex.  Else one
// thread a (vertex, lane pair), pairs fastest, so a warp writes whole
// 16-byte runs side by side and reads each lane's dist/lab in runs of
// consecutive vertices.
template <typename TD>
__global__ void pack_records_kernel(const TD* __restrict__ dist,
                                    const int32_t* __restrict__ lab, int2* __restrict__ rec,
                                    int64_t N, int B, int stride) {
  if (stride == 1) {
    const int64_t step = (int64_t)gridDim.x * blockDim.x;
    for (int64_t u = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; u < N; u += step)
      rec[u] = make_int2(__float_as_int(to_f32(dist[u])), lab[u]);
    return;
  }
  const int P = stride / 2;                            // lane pairs a vertex
  const int per = P < (int)blockDim.x ? P : (int)blockDim.x;  // threads a vertex
  const int vpb = blockDim.x / per;                    // vertices a block step
  const int uo = threadIdx.x / per, p0 = threadIdx.x % per;
  if (uo >= vpb) return;
  for (int64_t u = (int64_t)blockIdx.x * vpb + uo; u < N; u += (int64_t)gridDim.x * vpb) {
    for (int p = p0; p < P; p += per) {
      const int b = 2 * p;
      int4 v = make_int4(INF_BITS, IMAX, INF_BITS, IMAX);
      if (b < B) {
        v.x = __float_as_int(to_f32(dist[(int64_t)b * N + u]));
        v.y = lab[(int64_t)b * N + u];
      }
      if (b + 1 < B) {
        v.z = __float_as_int(to_f32(dist[(int64_t)(b + 1) * N + u]));
        v.w = lab[(int64_t)(b + 1) * N + u];
      }
      reinterpret_cast<int4*>(rec + u * stride)[p] = v;
    }
  }
}

// ---- host side

// Stages and consumer threads of a launch whose tiles hold TR rows or runs
// of P lane groups each, in stages of ``stage`` bytes: the ring takes
// RING_BUDGET bytes (2..4 stages) unless two stages need more; if two do
// not fit in shared memory, no ring (S = 0): the kernel reads in place.
struct TilePlan {
  int TR, S, CT;
  size_t smem;
};

TilePlan ring_plan(int TR, int P, size_t stage) {
  int S = 0;
  if (SMEM_HEADER + 2 * stage <= MAX_SMEM) {
    S = (int)(RING_BUDGET / stage);
    if (S < 2) S = 2;
    if (S > MAX_STAGES) S = MAX_STAGES;
  }
  const int64_t items = (int64_t)TR * P;
  const int CT = (int)(items < MAX_CONSUMERS ? (items + 31) & ~31 : MAX_CONSUMERS);
  return TilePlan{TR, S, CT, S ? SMEM_HEADER + S * stage : 0};
}

// A resident launch: a tile holds about ``block_rows`` (row, lane group)
// items, rounded to a multiple of 8 rows (16-byte aligned bulk copies), and
// halved until two stages fit.  Rows too wide for two stages of 8 (K above
// ~1800 in f32, ~2400 in bf16) get no ring.
TilePlan plan_tiles(int K, size_t wgt_size, int P, int block_rows) {
  int TR = (block_rows / P) & ~7;
  if (TR < 8) TR = 8;
  while (TR > 8 && SMEM_HEADER + 2 * row_stage_bytes(TR, K, wgt_size) > MAX_SMEM)
    TR = ((TR / 2) + 7) & ~7;
  return ring_plan(TR, P, row_stage_bytes(TR, K, wgt_size));
}

// Launches ``kernel`` persistent: as many blocks as fit on the card at
// once, at most one a tile of ``R`` rows or runs.
template <typename Kernel, typename... Args>
cudaError_t launch_persistent(Kernel kernel, int device, int64_t R, const TilePlan& pl,
                              cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)pl.smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, pl.CT + 32, pl.smem);
  if (e != cudaSuccess) return e;
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const int64_t ntiles = (R + pl.TR - 1) / pl.TR;
  const int64_t grid = ntiles < (int64_t)per_sm * sms ? ntiles : (int64_t)per_sm * sms;
  kernel<<<(unsigned)grid, pl.CT + 32, pl.smem, stream>>>(args...);
  return cudaGetLastError();
}

// B query lanes over (N, stride) records.  One lane (stride 1) launches the
// single kernel: its lane counts are fixed at compile time.
template <typename TW>
cudaError_t run_resident(int device, const void* nbr, const void* wgt, const void* rec,
                         void* out_m, void* out_l, void* out_s, int64_t R, int K, int B,
                         int stride, int block_rows, cudaStream_t stream) {
  const int32_t* n = static_cast<const int32_t*>(nbr);
  const TW* w = static_cast<const TW*>(wgt);
  const int2* r = static_cast<const int2*>(rec);
  float* om = static_cast<float*>(out_m);
  int32_t* ol = static_cast<int32_t*>(out_l);
  int32_t* os = static_cast<int32_t*>(out_s);
  if (B == 1) {
    if (stride != 1) return cudaErrorInvalidValue;
    const TilePlan pl = plan_tiles(K, sizeof(TW), 1, block_rows);
    return launch_persistent(minplus_resident_kernel<TW>, device, R, pl, stream, n, w, r, om,
                             ol, os, R, K, pl.TR, pl.S, pl.CT);
  }
  if (stride % 2 != 0 || stride < B) return cudaErrorInvalidValue;
  const int P = stride / 2;
  const TilePlan pl = plan_tiles(K, sizeof(TW), P, block_rows);
  return launch_persistent(minplus_resident_lanes_kernel<TW>, device, R, pl, stream, n, w, r,
                           om, ol, os, R, K, B, stride, P, pl.TR, pl.S, pl.CT);
}

template <typename TD>
cudaError_t run_pack(int device, const void* dist, const void* lab, void* rec, int64_t N, int B,
                     int stride, cudaStream_t stream) {
  int sms = 0;
  const cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const int64_t pairs = stride == 1 ? 1 : stride / 2;  // threads a vertex (up to 256)
  const int64_t per_block = 256 / (pairs < 256 ? pairs : 256);
  const int64_t want = (N + per_block - 1) / per_block, cap = (int64_t)sms * 16;
  pack_records_kernel<TD><<<(unsigned)(want < cap ? want : cap), 256, 0, stream>>>(
      static_cast<const TD*>(dist), static_cast<const int32_t*>(lab), static_cast<int2*>(rec),
      N, B, stride);
  return cudaGetLastError();
}

// One source slice, runs [run0, run0 + nruns) of the layout, for B lanes
// over (N, stride) records, in tiles of TR runs whose aligned slot spans
// hold at most ``cap`` slots.  One lane (stride 1) launches the single
// kernel.
template <typename TW>
cudaError_t run_blocked(int device, const void* nbr, const void* wgt, const void* run_row,
                        const void* run_off, int64_t run0, int64_t nruns, int TR, int cap,
                        const void* rec, void* out_m, void* out_l, void* out_s, int64_t R,
                        int B, int stride, cudaStream_t stream) {
  if (nruns == 0) return cudaSuccess;
  if (TR < 8 || TR % 8 != 0 || cap < 0 || cap % 8 != 0) return cudaErrorInvalidValue;
  const int32_t* n = static_cast<const int32_t*>(nbr);
  const TW* w = static_cast<const TW*>(wgt);
  const int32_t* rr = static_cast<const int32_t*>(run_row);
  const int64_t* ro = static_cast<const int64_t*>(run_off);
  const int2* r = static_cast<const int2*>(rec);
  float* om = static_cast<float*>(out_m);
  int32_t* ol = static_cast<int32_t*>(out_l);
  int32_t* os = static_cast<int32_t*>(out_s);
  const size_t stage = run_stage_bytes(TR, cap, sizeof(TW));
  if (B == 1) {
    if (stride != 1) return cudaErrorInvalidValue;
    const TilePlan pl = ring_plan(TR, 1, stage);
    return launch_persistent(minplus_blocked_kernel<TW>, device, nruns, pl, stream, n, w, rr,
                             ro, run0, nruns, r, om, ol, os, R, cap, TR, pl.S, pl.CT);
  }
  if (stride % 2 != 0 || stride < B) return cudaErrorInvalidValue;
  const int P = stride / 2;
  const TilePlan pl = ring_plan(TR, P, stage);
  return launch_persistent(minplus_blocked_lanes_kernel<TW>, device, nruns, pl, stream, n, w,
                           rr, ro, run0, nruns, r, om, ol, os, R, cap, B, stride, P, TR, pl.S,
                           pl.CT);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Records: int32 pairs (dist as
// f32 bits, lab), 16-byte aligned, as minplus_pack_records writes them.
extern "C" {

// dist/lab: (B, N) (B = 1 for (N,)); rec: (N, stride) records, stride = 1
// for B = 1, else B rounded up to even.
int minplus_pack_records(int device, int dist_dtype, const void* dist, const void* lab,
                         void* rec, int64_t N, int B, int stride, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (N == 0) return 0;
  if (stride != (B == 1 ? 1 : B + B % 2)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dist_dtype == 0) return (int)run_pack<float>(device, dist, lab, rec, N, B, stride, st);
  if (dist_dtype == 1)
    return (int)run_pack<__nv_bfloat16>(device, dist, lab, rec, N, B, stride, st);
  return (int)cudaErrorInvalidValue;
}

// rec: (N, stride) lane-minor records, stride = 1 for B = 1, else even.
int minplus_resident_lanes(int device, int wgt_dtype, const void* nbr, const void* wgt,
                           const void* rec, void* out_m, void* out_l, void* out_s, int64_t R,
                           int K, int B, int stride, int block_rows, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wgt_dtype == 0)
    return (int)run_resident<float>(device, nbr, wgt, rec, out_m, out_l, out_s, R, K, B,
                                    stride, block_rows, st);
  if (wgt_dtype == 1)
    return (int)run_resident<__nv_bfloat16>(device, nbr, wgt, rec, out_m, out_l, out_s, R, K,
                                            B, stride, block_rows, st);
  return (int)cudaErrorInvalidValue;
}

// One source slice of a blocked layout: runs [run0, run0 + nruns) over its
// slots (nbr, wgt) and run table (run_row, run_off), all 16-byte aligned and
// padded past their aligned ends (see RunTiles), in tiles of TR runs whose
// 8-slot aligned spans hold at most ``cap`` slots; for B lanes over (N,
// stride) records; out_*: (B, R), from the group's first lane.
int minplus_blocked(int device, int wgt_dtype, const void* nbr, const void* wgt,
                    const void* run_row, const void* run_off, int64_t run0, int64_t nruns,
                    int TR, int cap, const void* rec, void* out_m, void* out_l, void* out_s,
                    int64_t R, int B, int stride, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wgt_dtype == 0)
    return (int)run_blocked<float>(device, nbr, wgt, run_row, run_off, run0, nruns, TR, cap,
                                   rec, out_m, out_l, out_s, R, B, stride, st);
  if (wgt_dtype == 1)
    return (int)run_blocked<__nv_bfloat16>(device, nbr, wgt, run_row, run_off, run0, nruns, TR,
                                           cap, rec, out_m, out_l, out_s, R, B, stride, st);
  return (int)cudaErrorInvalidValue;
}

const char* minplus_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
