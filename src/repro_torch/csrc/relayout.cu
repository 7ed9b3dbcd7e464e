// Blocked-layout transform (the Torrent DSE relayout) for Hopper.
//
// Replaces: src/repro/kernels/relayout/kernel.py:relayout_pallas (body
// _relayout_kernel, super-tiling _supertile) — an (M, N) matrix stored
// blocked as (M/sbm, N/sbn, sbm, sbn) is rewritten blocked as
// (M/dbm, N/dbn, dbm, dbn). The dtype is kept and every byte is moved
// unchanged, so the result matches relayout_ref bit for bit.
//
// Bound on the H100: bytes. The kernel does no arithmetic on the data;
// it reads every input byte once and writes every output byte once, so
// its floor is 2 * M * N * elsize / 3.35 TB/s. The design keeps the
// index arithmetic and the load/store width from becoming the limit:
//
// * Every offset is 32-bit. The wrapper (kernels/relayout/ops.py) splits
//   a transform whose byte extent exceeds 2^31 into row bands that are
//   contiguous in both layouts and launches each band with offset
//   pointers, so no offset a kernel forms reaches 2^31.
// * Every runtime division is a multiply-high by a magic number the
//   wrapper computed (Div below); no 64-bit division is left.
// * Three routes, chosen by the wrapper from the shapes and the pointer
//   alignment, each its own kernel:
//   - copy: the two byte orders are equal (e.g. the paged-KV case
//     (1, F) -> (page, F)). A streaming copy with four independent
//     16-byte loads in flight per thread, all issued before the first
//     store, and a byte tail.
//   - staged: the general permutation. The TPU kernel stages an lcm
//     super-tile in VMEM; here a persistent grid walks super-tiles of
//     lcm(sbm,dbm) x lcm(sbn,dbn) (scaled up by the wrapper) through a
//     2-stage shared-memory ring. A super-tile's source blocks are
//     TM/sbm contiguous runs; they come in as 16-byte cp.async copies
//     (the next tile's load overlaps this tile's stores). Threads then
//     gather each 16-byte destination unit from shared memory in the
//     widest piece (1-16 bytes) that is contiguous in both layouts and
//     store it as one 16-byte vector, whatever the block width. Shared
//     memory is XOR-swizzled at 16-byte granularity (a per-128-byte-line
//     constant the wrapper picks by simulating the gather's banks).
//   - direct: what the other two do not take (misaligned pointers, a
//     super-tile too large for shared memory). Each output unit of up
//     to 16 bytes maps its destination-blocked index to the source
//     offset; a thread keeps four units in flight.
//
// Interface: relayout_launch(src, dst, plan, stream) with `plan` a host
// array of 32-bit words that the wrapper builds once per (shape, blocks,
// element size, pointer alignment) and caches; the word order of each
// route is written beside its struct and in ops.py.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;

// Exact n / d for 0 <= n < 2^31 and 1 <= d < 2^31:
// q = (umulhi(n, mul) + n) >> shift with shift = ceil(log2 d) and
// mul = floor(2^32 * (2^shift - d) / d) + 1 (ops._magic computes both).
struct Div {
  uint32_t mul, shift, d;
  __device__ __forceinline__ uint32_t div(uint32_t n) const {
    return (__umulhi(n, mul) + n) >> shift;
  }
  __device__ __forceinline__ uint32_t divmod(uint32_t n, uint32_t& r) const {
    const uint32_t q = div(n);
    r = n - q * d;
    return q;
  }
};

// ---- copy ---------------------------------------------------------------------
// words: route, grid, units (16-byte), tail (bytes after the last unit)
struct CopyP {
  uint32_t route, grid, units, tail;
};

__global__ void __launch_bounds__(kThreads) relayout_copy_kernel(
    const uint4* __restrict__ src, uint4* __restrict__ dst, CopyP p) {
  constexpr uint32_t kIn = 4;  // independent loads in flight per thread
  const uint32_t chunk = kIn * kThreads;
  const uint32_t step = gridDim.x * chunk;
  for (uint32_t base = blockIdx.x * chunk; base < p.units; base += step) {
    const uint32_t u = base + threadIdx.x;
    uint4 v[kIn];
    if (base + chunk <= p.units) {
#pragma unroll
      for (uint32_t k = 0; k < kIn; ++k) v[k] = __ldg(src + u + k * kThreads);
#pragma unroll
      for (uint32_t k = 0; k < kIn; ++k) dst[u + k * kThreads] = v[k];
    } else {
#pragma unroll
      for (uint32_t k = 0; k < kIn; ++k)
        if (u + k * kThreads < p.units) v[k] = __ldg(src + u + k * kThreads);
#pragma unroll
      for (uint32_t k = 0; k < kIn; ++k)
        if (u + k * kThreads < p.units) dst[u + k * kThreads] = v[k];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < p.tail) {
    const uint8_t* s = reinterpret_cast<const uint8_t*>(src + p.units);
    reinterpret_cast<uint8_t*>(dst + p.units)[threadIdx.x] = s[threadIdx.x];
  }
}

// ---- staged -------------------------------------------------------------------
// All sizes in bytes unless named in elements. A tile is TM x TN
// elements; its source side is src_segs runs of src_seg bytes, one per
// source block row, src_stride apart (the same for the destination).
struct StagedP {
  uint32_t route, grid, piece;
  uint32_t smem;          // two stages, each tile_bytes rounded up to 128
  uint32_t n_tiles;
  Div tiles_n;            // tiles along N
  uint32_t tile_row;      // bytes of one row of tiles (TM * N * elsize), both layouts
  uint32_t src_seg, dst_seg;        // bytes of one run
  uint32_t src_stride, dst_stride;  // bytes between runs
  uint32_t tile_bytes;
  Div src_seg16;          // 16-byte chunks per source run
  Div dst_seg16;          // 16-byte units per destination run
  uint32_t piece_elems, es_shift;
  Div dbn, dbm, nbd, sbm, sbn;      // elements; nbd = TN / dbn
  uint32_t nbs;                     // TN / sbn
  uint32_t swz;                     // swizzle multiplier (0..7)
};

__device__ __forceinline__ uint32_t swizzle(uint32_t b, uint32_t m) {
  const uint32_t c = b >> 4, line = c >> 3;
  return (((line << 3) | ((c ^ (line * m)) & 7)) << 4) | (b & 15);
}

__device__ __forceinline__ void cp_async16(uint32_t smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem), "l"(gmem)
               : "memory");
}

template <int G>
struct PieceT;
template <> struct PieceT<1> { using T = uint8_t; };
template <> struct PieceT<2> { using T = uint16_t; };
template <> struct PieceT<4> { using T = uint32_t; };
template <> struct PieceT<8> { using T = uint2; };
template <> struct PieceT<16> { using T = uint4; };

template <int G>
__global__ void __launch_bounds__(kThreads) relayout_staged_kernel(
    const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, StagedP p) {
  using T = typename PieceT<G>::T;
  constexpr uint32_t kPieces = 16 / G;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t smem0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t chunks = p.tile_bytes >> 4;
  const uint32_t stage_bytes = p.smem >> 1;  // a multiple of 128: whole swizzle lines

  auto load = [&](uint32_t tile, uint32_t stage) {
    uint32_t tc;
    const uint32_t tr = p.tiles_n.divmod(tile, tc);
    const uint8_t* base = src + tr * p.tile_row + tc * p.src_seg;
    const uint32_t sbase = smem0 + stage * stage_bytes;
    for (uint32_t c = threadIdx.x; c < chunks; c += kThreads) {
      uint32_t w;
      const uint32_t seg = p.src_seg16.divmod(c, w);
      cp_async16(sbase + swizzle(c << 4, p.swz), base + seg * p.src_stride + (w << 4));
    }
  };

  uint32_t tile = blockIdx.x;
  if (tile < p.n_tiles) load(tile, 0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (uint32_t k = 0; tile < p.n_tiles; ++k, tile += gridDim.x) {
    const uint32_t next = tile + gridDim.x;
    if (next < p.n_tiles) load(next, (k + 1) & 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");  // may be empty
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this tile's copies
    __syncthreads();

    uint32_t tc;
    const uint32_t tr = p.tiles_n.divmod(tile, tc);
    uint8_t* obase = dst + tr * p.tile_row + tc * p.dst_seg;
    const uint8_t* stile = smem + (k & 1) * stage_bytes;
    for (uint32_t u = threadIdx.x; u < chunks; u += kThreads) {
      union {
        uint4 v;
        T piece[kPieces];
      } out;
#pragma unroll
      for (uint32_t q = 0; q < kPieces; ++q) {
        // destination-tile element -> (r, bj, ii, jj) -> tile-dense (i, j)
        const uint32_t e = (u * kPieces + q) * p.piece_elems;
        uint32_t jj, ii, bj;
        uint32_t t = p.dbn.divmod(e, jj);
        t = p.dbm.divmod(t, ii);
        const uint32_t r = p.nbd.divmod(t, bj);
        const uint32_t i = r * p.dbm.d + ii, j = bj * p.dbn.d + jj;
        // -> source-tile element, as laid out in shared memory
        uint32_t ir, jr;
        const uint32_t is = p.sbm.divmod(i, ir), js = p.sbn.divmod(j, jr);
        const uint32_t s = ((is * p.nbs + js) * p.sbm.d + ir) * p.sbn.d + jr;
        out.piece[q] = *reinterpret_cast<const T*>(stile + swizzle(s << p.es_shift, p.swz));
      }
      uint32_t w;
      const uint32_t seg = p.dst_seg16.divmod(u, w);
      *reinterpret_cast<uint4*>(obase + seg * p.dst_stride + (w << 4)) = out.v;
    }
    __syncthreads();  // this stage is reloaded by the next iteration's load
  }
}

// ---- direct -------------------------------------------------------------------
// Extents along N (dbn, sbn, nbs) are in units of U; M-axis ones in rows.
struct DirectP {
  uint32_t route, grid, unit, total;
  Div dbn, dbm, nbd, sbm, sbn;  // nbd = N / dbn
  uint32_t nbs;                 // N / sbn
};

__device__ __forceinline__ uint32_t direct_source(const DirectP& p, uint32_t o) {
  uint32_t jj, ii, bj;
  uint32_t t = p.dbn.divmod(o, jj);
  t = p.dbm.divmod(t, ii);
  const uint32_t bi = p.nbd.divmod(t, bj);
  const uint32_t i = bi * p.dbm.d + ii, j = bj * p.dbn.d + jj;
  uint32_t ir, jr;
  const uint32_t is = p.sbm.divmod(i, ir), js = p.sbn.divmod(j, jr);
  return ((is * p.nbs + js) * p.sbm.d + ir) * p.sbn.d + jr;
}

// Each thread keeps four independent units in flight: four loads, then
// four stores (units `stride` apart, so a warp's stores stay coalesced).
template <typename U>
__global__ void __launch_bounds__(kThreads) relayout_direct_kernel(
    const U* __restrict__ src, U* __restrict__ dst, DirectP p) {
  constexpr uint32_t kIn = 4;
  const uint32_t stride = gridDim.x * kThreads;
  for (uint32_t o = blockIdx.x * kThreads + threadIdx.x; o < p.total; o += kIn * stride) {
    U v[kIn];
#pragma unroll
    for (uint32_t k = 0; k < kIn; ++k)
      if (o + k * stride < p.total) v[k] = __ldg(src + direct_source(p, o + k * stride));
#pragma unroll
    for (uint32_t k = 0; k < kIn; ++k)
      if (o + k * stride < p.total) dst[o + k * stride] = v[k];
  }
}

template <typename P>
bool unpack(const uint32_t* words, P* p) {
  static_assert(sizeof(P) % 4 == 0, "plan structs are arrays of 32-bit words");
  memcpy(p, words, sizeof(P));
  return p->grid > 0;
}

template <int G>
cudaError_t launch_staged(const void* src, void* dst, const StagedP& p, cudaStream_t s) {
  if (p.smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(relayout_staged_kernel<G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)p.smem);
    if (e != cudaSuccess) return e;
  }
  relayout_staged_kernel<G><<<p.grid, kThreads, p.smem, s>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), p);
  return cudaGetLastError();
}

template <typename U>
cudaError_t launch_direct(const void* src, void* dst, const DirectP& p, cudaStream_t s) {
  relayout_direct_kernel<U><<<p.grid, kThreads, 0, s>>>(static_cast<const U*>(src),
                                                          static_cast<U*>(dst), p);
  return cudaGetLastError();
}

}  // namespace

// Size in 32-bit words of each route's plan (route 0 copy, 1 staged,
// 2 direct); the wrapper checks its own plans against these.
extern "C" int relayout_plan_words(int route) {
  switch (route) {
    case 0: return (int)(sizeof(CopyP) / 4);
    case 1: return (int)(sizeof(StagedP) / 4);
    case 2: return (int)(sizeof(DirectP) / 4);
    default: return -1;
  }
}

// Launch one band. Returns the CUDA error of the launch (0 on success).
extern "C" int relayout_launch(const void* src, void* dst, const uint32_t* plan,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (plan[0]) {
    case 0: {
      CopyP p;
      if (!unpack(plan, &p)) return (int)cudaErrorInvalidValue;
      relayout_copy_kernel<<<p.grid, kThreads, 0, s>>>(static_cast<const uint4*>(src),
                                                       static_cast<uint4*>(dst), p);
      return (int)cudaGetLastError();
    }
    case 1: {
      StagedP p;
      if (!unpack(plan, &p)) return (int)cudaErrorInvalidValue;
      switch (p.piece) {
        case 1: return (int)launch_staged<1>(src, dst, p, s);
        case 2: return (int)launch_staged<2>(src, dst, p, s);
        case 4: return (int)launch_staged<4>(src, dst, p, s);
        case 8: return (int)launch_staged<8>(src, dst, p, s);
        case 16: return (int)launch_staged<16>(src, dst, p, s);
        default: return (int)cudaErrorInvalidValue;
      }
    }
    case 2: {
      DirectP p;
      if (!unpack(plan, &p)) return (int)cudaErrorInvalidValue;
      switch (p.unit) {
        case 1: return (int)launch_direct<uint8_t>(src, dst, p, s);
        case 2: return (int)launch_direct<uint16_t>(src, dst, p, s);
        case 4: return (int)launch_direct<uint32_t>(src, dst, p, s);
        case 8: return (int)launch_direct<uint2>(src, dst, p, s);
        case 16: return (int)launch_direct<uint4>(src, dst, p, s);
        default: return (int)cudaErrorInvalidValue;
      }
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}
