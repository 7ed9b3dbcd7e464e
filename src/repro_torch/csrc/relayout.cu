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
// its floor is 2 * M * N * elsize / 3.35 TB/s.
//
// Design: the TPU kernel stages a super-tile in VMEM and re-tiles it in
// registers, because its grid walks tiles in order on one core. Here
// blocks run in parallel and nothing needs staging: each thread owns one
// output unit and maps it destination-blocked index -> dense (i, j) ->
// source-blocked offset. Consecutive threads write consecutive output
// addresses (coalesced stores); the reads are coalesced along each
// block row. A unit is up to 16 bytes: the wrapper picks the widest unit
// (16, 8, 4, 2 or 1 bytes) that divides both block rows and the two
// pointers' alignment, and passes every N-axis extent in units, so one
// kernel serves element sizes 1, 2, 4 and 8. For the paged-KV case
// (1, F) -> (page, F) both sides have the same byte order: the kernel
// still runs, as a pure 16-byte streaming copy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename U>
__global__ void relayout_kernel(const U* __restrict__ src, U* __restrict__ dst,
                                long long N, long long sbm, long long sbn,
                                long long dbm, long long dbn, long long total) {
  const long long src_block = sbm * sbn;
  const long long nb_src = N / sbn;
  const long long nb_dst = N / dbn;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x; o < total;
       o += stride) {
    // destination-blocked index -> (bi, bj, ii, jj)
    const long long jj = o % dbn;
    long long t = o / dbn;
    const long long ii = t % dbm;
    t /= dbm;
    const long long bj = t % nb_dst;
    const long long bi = t / nb_dst;
    // dense (i, j)
    const long long i = bi * dbm + ii;
    const long long j = bj * dbn + jj;
    // source-blocked offset
    const long long s = ((i / sbm) * nb_src + j / sbn) * src_block +
                        (i % sbm) * sbn + (j % sbn);
    dst[o] = src[s];
  }
}

template <typename U>
cudaError_t launch(const void* src, void* dst, long long M, long long N,
                   long long sbm, long long sbn, long long dbm, long long dbn,
                   cudaStream_t stream) {
  const long long total = M * N;
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  const long long cap = 132LL * 16;  // a few waves of resident blocks; the loop strides
  if (blocks > cap) blocks = cap;
  relayout_kernel<U><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const U*>(src), static_cast<U*>(dst), N, sbm, sbn, dbm, dbn, total);
  return cudaGetLastError();
}

}  // namespace

// M rows; N, sbn and dbn are counted in units of `unit_bytes` bytes.
// Returns the CUDA error of the launch (0 on success).
extern "C" int relayout_launch(const void* src, void* dst, long long M, long long N,
                               long long sbm, long long sbn, long long dbm,
                               long long dbn, int unit_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 0 || N < 0 || sbm <= 0 || sbn <= 0 || dbm <= 0 || dbn <= 0 ||
      M % sbm || M % dbm || N % sbn || N % dbn)
    return (int)cudaErrorInvalidValue;
  switch (unit_bytes) {
    case 1: return (int)launch<uint8_t>(src, dst, M, N, sbm, sbn, dbm, dbn, s);
    case 2: return (int)launch<uint16_t>(src, dst, M, N, sbm, sbn, dbm, dbn, s);
    case 4: return (int)launch<uint32_t>(src, dst, M, N, sbm, sbn, dbm, dbn, s);
    case 8: return (int)launch<uint2>(src, dst, M, N, sbm, sbn, dbm, dbn, s);
    case 16: return (int)launch<uint4>(src, dst, M, N, sbm, sbn, dbm, dbn, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
