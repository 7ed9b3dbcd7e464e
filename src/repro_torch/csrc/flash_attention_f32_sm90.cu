// Forward flash attention for f32 inputs on Hopper's tensor cores, kept
// f32-accurate by splitting every product three ways in TF32 ("3xTF32"):
// a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi, with x_hi = tf32(x) and
// x_lo = tf32(x - x_hi) (cvt.rna.tf32.f32), which keeps ~21 bits of
// mantissa; only the a_lo b_lo term (~2^-22 relative) is dropped.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:flash_attention_pallas
// (body _flash_kernel) for float32 inputs whose head dim D is a multiple
// of 8 in [8, 256].
// Same semantics as the Pallas kernel: q (B, H, Sq, D), k and v
// (B, Hkv, Sk, D); query head h reads kv head h / (H / Hkv); masks
// col <= row (causal) and col > row - window, where q's row i is row
// q_off + i of the sequence (Sq = Sk and q_off = 0 is the Pallas
// kernel's square call); f32 running max, running
// sum and accumulator; the finite sentinel -1e30 (never -inf) for masked
// scores, with the Pallas order m_new = max(m, rowmax), alpha =
// exp(m - m_new), p = exp(s - m_new), l = alpha l + sum p, acc = alpha acc
// + p V; a row whose sum is 0 outputs 0; output f32.
//
// Bound on the H100: causal prefill does 4 D H S(S+1)/2 flops; on the
// CUDA cores (67 TFLOP/s f32) that is 0.0321 ms at yi-6b's heads and
// S = 512, 2.05 ms at S = 4096. Three TF32 products run at 495 / 3 =
// 165 TFLOP/s, so this design's floor is 0.0130 ms and 0.833 ms; the
// bytes, (2H + 2Hkv) S D 4 = 18.9 MB at S = 512, take 0.0056 ms. At
// D = 192 (16 heads, S = 4096) the floor is 0.625 ms, at D = 256 (8
// heads) 0.417 ms.
//
// Design:
//
// * wgmma takes .tf32 operands from shared memory only K-major (the
//   transpose flags exist for 16-bit types alone). V is stored (kv, D),
//   MN-major as the B operand of P V, so a pre-pass kernel,
//   tf32x3_split_kernel, writes K's hi/lo parts as (Bkv, 2, S, D) and
//   V^T's as (Bkv, 2, D, Sp) with kv contiguous (Sp = S rounded up to
//   32, zeros past S). It reads each kv head once, instead of every q
//   tile of every query head splitting it again. Q is split inside the
//   main kernel, in shared memory, once per block: it is read by one
//   block only, and a pre-pass for it would write and read it twice.
// * S = Q K^T is three batches of wgmma m64n32k8 (Q from shared memory,
//   small terms first: Q_lo K_hi, Q_hi K_lo, Q_hi K_hi) into one f32
//   accumulator. P stays in registers: it is split into hi/lo and fed as
//   the register A operand of three batches of m64n64k8 against V^T.
// * The f32 accumulator gives a thread columns (2c, 2c+1) of each
//   8-column slice, where the tf32 A fragment wants columns (c, c+4).
//   Instead of shuffling P, the pre-pass stores each group of 8 kv rows
//   of V^T in the order 0 2 4 6 1 3 5 7 (ops.TF32X3_KV_ORDER, pinned by
//   tests/test_torch_flash.py): logical column c of the fragment is then
//   kv 2c and column c + 4 is kv 2c + 1, and a sum over kv ignores order.
// * Shared memory at D = 128: Q hi + lo 64 KB; a ring stage of 32 kv
//   rows holds K hi/lo (2 x 16 KB) and V^T hi/lo (2 x 16 KB); two stages
//   make 192 KB, one block per SM. At D <= 64 it is half, two blocks per
//   SM. Shared memory grows as 1536 D bytes, so D > 128 (288 KB at 192,
//   384 KB at 256) does not fit one block's 227 KB.
// * D in (128, 256] runs on a cluster of two blocks that split the head
//   dim: the pair shares one (head, 64-row q tile), and block r holds
//   columns [r DPH, (r + 1) DPH) of Q and K and those rows of V^T, with
//   DPH = DP / 2 (96 or 128; DP is D rounded up to 64). Each block is the
//   single-block kernel at DPH columns (144 or 192 KB, plus 16 KB for
//   two exchange buffers). Per kv tile each block computes the partial
//   scores of its half and stores them into its peer's exchange buffer
//   (distributed shared memory: mapa, then st.async, which completes
//   transaction bytes on the peer's mbarrier as a TMA load does, with no
//   fence), and adds the peer's partial to its own once its own mbarrier
//   has all the bytes. Thread t of both blocks holds the same score
//   elements, so each thread sends 16 floats to its counterpart only, and
//   f32 addition commutes: both blocks hold the same scores bit for bit
//   and run the same softmax. Each block then computes P V for its own
//   DPH output columns and stores them. The exchange waits while the
//   previous tile's P V runs. Two buffers alternate by tile; a block
//   sends into a buffer again only after the peer's bytes for the tile in
//   between have landed, and the peer sends those after reading the
//   buffer, so no other barrier guards them.
// * The rest is the bf16 kernel's skeleton (flash_attention_sm90.cu): a
//   producer warpgroup of which one thread issues TMA loads (3-D tensor
//   maps, 128-byte swizzle, rows past S and columns past D read as
//   zeros) into a 2-stage ring with full/empty mbarriers; one consumer
//   warpgroup owns 64 q rows; q tiles are walked longest-causal-first;
//   fully masked kv tiles are skipped and element masks run only on edge
//   tiles. With at most two blocks of 256 threads per SM every thread may
//   hold 128 registers or more, so no setmaxnreg is needed.
// * With one block per SM at D = 128 nothing else fills the tensor cores
//   while the consumer does a softmax, so the consumer pipelines in
//   software: it issues Q K^T of tile n, then P V of tile n - 1, waits
//   for the first only, and runs tile n's softmax while P V runs. K and
//   V stages have their own empty barriers: K is released when its
//   Q K^T is done, V when its P V is, and the producer refills K a whole
//   tile ahead.
//
// Left for later: two consumer warpgroups per block (one warpgroup's
// softmax under the other's products; needs setmaxnreg and Q_hi in
// registers, as shared memory is full at D = 128). Q_hi in registers for
// one warpgroup (two of the three Q K^T products then read only K from
// shared memory) gained only 3%, so the shared-memory rate of Q K^T is
// not the limit.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 64;  // q rows per block (one consumer warpgroup)
constexpr int BN = 32;  // kv rows per ring stage: one 128-byte row of V^T
constexpr int STAGES = 2;
constexpr int CONSUMER_THREADS = 128;
constexpr int THREADS = CONSUMER_THREADS + 128;  // + the producer warpgroup
constexpr int MAX_D = 256;
constexpr int EXCHANGE = CONSUMER_THREADS * 16 * 4;  // one tile's partial scores
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int ROW = 128;  // bytes of one swizzled row: 32 f32 values

// Shared memory of one block, as byte offsets from a 1024-aligned base.
// DPH is the head-dim columns the block holds: D rounded up to 64 (the N
// width of one P V^T instruction) for a lone block, half of that for
// each block of a pair, which adds two exchange buffers.
template <int DPH, bool PAIR>
struct Smem {
  static constexpr int ATOMS = DPH / 32;        // 32-column blocks of the head dim
  static constexpr int Q_ATOM = BM * ROW;       // 64 rows x 128 bytes
  static constexpr int K_ATOM = BN * ROW;       // 32 rows x 128 bytes
  static constexpr int QH = 0;
  static constexpr int QL = QH + ATOMS * Q_ATOM;
  static constexpr int KTILE = ATOMS * K_ATOM;  // K hi or K lo of one stage
  static constexpr int VTILE = DPH * ROW;       // V^T hi or lo: DPH rows of 32 kv
  static constexpr int STAGE = 2 * KTILE + 2 * VTILE;
  static constexpr int RING = QL + ATOMS * Q_ATOM;
  static constexpr int XCHG = RING + STAGES * STAGE;  // the peer's partial scores, x2
  // full_k[], full_v[], empty_k[], empty_v[], q_full, xchg_full[2]
  static constexpr int BAR = XCHG + (PAIR ? 2 * EXCHANGE : 0);
  static constexpr int BYTES = BAR + (4 * STAGES + 3) * 8;
  static constexpr int ALLOC = BYTES + 1024;    // slack to align the base
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait for the phase of parity `parity` to complete; trap after billions
// of cycles (a lost transaction), so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 33)) __trap();
  }
}

// ---- the cluster (a pair of blocks) -------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// The address of the same shared-memory byte in block `rank` of the cluster.
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// 16 bytes into a peer's shared memory, asynchronously: the peer's
// mbarrier `bar` counts them as completed transaction bytes, as it
// counts a TMA load's, so no fence orders them.
__device__ __forceinline__ void st_async(uint32_t addr, float a, float b, float c, float d,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "f"(a), "f"(b), "f"(c), "f"(d), "r"(bar)
      : "memory");
}

// Every thread of both blocks: no block reads or writes its peer's
// shared memory before the peer has started, or after it has exited.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// ---- TMA ---------------------------------------------------------------------

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0,
                                            int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---- wgmma -------------------------------------------------------------------

// Descriptor of a K-major operand in 128-byte-swizzled rows: 8-row groups
// 1024 bytes apart; one k8 step of tf32 is 32 bytes along the row.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define ACC16(d)                                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),      \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define ACC32(d)                                                                       \
  ACC16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),           \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),    \
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define REGS16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define REGS32                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, " \
  "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 32, f32) (+)= A (64 x 8 tf32, shared, K-major) . B (8 x 32 tf32,
// shared, K-major); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " REGS16
               ", %16, %17, p, 1, 1;\n}\n"
               : ACC16(d)
               : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 8 tf32, registers) . B (8 x 64 tf32, shared,
// K-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " REGS32
               ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
               : ACC32(d)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 32, f32) += A (64 x 8 tf32, registers) . B (8 x 32 tf32, shared,
// K-major): the last 32 columns of a DPH = 96 block.
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " REGS16
               ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
               : ACC16(d)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---- numerics ----------------------------------------------------------------

// Round to TF32 (10 mantissa bits), to nearest, ties away from zero.
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return __uint_as_float(y);
}

__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - hi);
}

__device__ __forceinline__ float exp2_approx(float x) {  // exp2(-1e30) == 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- the pre-pass: K and V^T split into TF32 hi/lo parts --------------------

// One block per (32 kv rows, 32 columns, kv head). K (Bkv, S, D) ->
// ks (Bkv, 2, S, D); V (Bkv, S, D) -> vt (Bkv, 2, D, Sp) through a
// shared-memory transpose, each group of 8 kv positions holding kv rows
// 0 2 4 6 1 3 5 7 of the group, and zeros for kv >= S.
__global__ void __launch_bounds__(256)
tf32x3_split_kernel(const float* __restrict__ k, const float* __restrict__ v,
                    float* __restrict__ ks, float* __restrict__ vt, int S, int D, int Sp) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int s0 = blockIdx.x * 32;
  const int d0 = blockIdx.y * 32;
  const size_t head = blockIdx.z;
  const float* kb = k + head * S * D;
  const float* vb = v + head * S * D;
  float* kh = ks + head * 2 * S * D;
  float* kl = kh + (size_t)S * D;
  for (int r = ty; r < 32; r += 8) {
    const int s = s0 + r;
    const int d = d0 + tx;
    float x = 0.f;
    if (s < S && d < D) {
      const size_t i = (size_t)s * D + d;
      float hi, lo;
      split(kb[i], hi, lo);
      kh[i] = hi;
      kl[i] = lo;
      x = vb[i];
    }
    tile[r][tx] = x;
  }
  __syncthreads();
  float* vh = vt + head * 2 * D * Sp;
  float* vl = vh + (size_t)D * Sp;
  const int src = (tx & ~7) | ((tx & 3) << 1) | ((tx >> 2) & 1);  // kv of position tx
  for (int r = ty; r < 32; r += 8) {
    const int d = d0 + r;
    if (d < D) {
      float hi, lo;
      split(tile[src][r], hi, lo);
      const size_t i = (size_t)d * Sp + s0 + tx;
      vh[i] = hi;
      vl[i] = lo;
    }
  }
}

// ---- the main kernel -----------------------------------------------------------

// Accumulator layout of wgmma m64nN (f32), thread t of the warpgroup:
// warp w = t / 32 owns rows 16 w .. 16 w + 15; with g = (t % 32) / 4 and
// c = t % 4, register 4 i + e holds row 16 w + g + 8 (e / 2), column
// 8 i + 2 c + (e % 2). The tf32 A fragment of a k8 slice is
// {(g, c), (g + 8, c), (g, c + 4), (g + 8, c + 4)}, so registers
// {4 i, 4 i + 2, 4 i + 1, 4 i + 3} of the scores are the fragment of
// slice i when V^T's kv rows are stored in the order 0 2 4 6 1 3 5 7.
template <int DPH, bool PAIR>
__global__ void __launch_bounds__(THREADS, DPH <= 64 ? 2 : 1)
flash_fwd_tf32x3_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, float* __restrict__ o,
                        int H, int Hkv, int Sq, int Sk, int q_off, int D, int causal,
                        int has_window, int window, float scale_log2) {
  using L = Smem<DPH, PAIR>;
  constexpr int NB = DPH / 64;          // 64-column blocks of P V
  constexpr bool TAIL = DPH % 64 != 0;  // and a last 32-column one (DPH = 96)
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);  // the same bytes, generic address
  const uint32_t bar = base + L::BAR;
  auto full_k = [&](int s) { return bar + 8u * s; };
  auto full_v = [&](int s) { return bar + 8u * (STAGES + s); };
  auto empty_k = [&](int s) { return bar + 8u * (2 * STAGES + s); };
  auto empty_v = [&](int s) { return bar + 8u * (3 * STAGES + s); };
  const uint32_t q_full = bar + 8u * (4 * STAGES);
  auto xchg_full = [&](int b) { return bar + 8u * (4 * STAGES + 1 + b); };

  // A pair's two blocks are neighbours along x and share (b h, q tile);
  // block `rank` holds head-dim columns [col0, col0 + DPH). Launched
  // without a cluster of two, the pair kernel fails instead of reading
  // a peer that is not there.
  if (PAIR && cluster_size() != 2) __trap();
  const uint32_t rank = PAIR ? cluster_rank() : 0;
  const int bh = PAIR ? blockIdx.x >> 1 : blockIdx.x;
  const int col0 = rank * DPH;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // longest causal tiles first
  const int b = bh / H;
  const int kvh = b * Hkv + (bh - b * H) / (H / Hkv);

  // The kv tiles this q tile needs, [t0, t1): the same walk for the
  // producer and the consumers (and for both blocks of a pair). g0 and
  // g_last are the tile's first and last rows in the sequence.
  const int g0 = q_off + q0;
  const int g_last = q_off + min(q0 + BM, Sq) - 1;
  int t1 = (Sk + BN - 1) / BN;
  if (causal) t1 = min(t1, g_last / BN + 1);
  int t0 = 0;
  if (has_window) {
    while (t0 < t1 && min(t0 * BN + BN, Sk) - 1 <= g0 - window) ++t0;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), CONSUMER_THREADS);
      mbar_init(empty_v(s), CONSUMER_THREADS);
    }
    mbar_init(q_full, 1);
    if (PAIR) {
      mbar_init(xchg_full(0), 1);  // + the peer's EXCHANGE bytes
      mbar_init(xchg_full(1), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (PAIR)
    cluster_sync();
  else
    __syncthreads();

  if (threadIdx.x >= CONSUMER_THREADS) {
    // ===== producer warpgroup: every load of the block, from one thread =====
    if (threadIdx.x == CONSUMER_THREADS) {
      mbar_expect_tx(q_full, L::ATOMS * L::Q_ATOM);
      for (int j = 0; j < L::ATOMS; ++j)
        tma_load_3d(base + L::QH + j * L::Q_ATOM, &tq, col0 + 32 * j, q0, bh, q_full);
      for (int t = t0, n = 0; t < t1; ++t, ++n) {
        const int s = n % STAGES;
        const uint32_t st = base + L::RING + s * L::STAGE;
        const uint32_t vacant = ((n / STAGES) & 1) ^ 1;
        mbar_wait(empty_k(s), vacant);
        mbar_expect_tx(full_k(s), 2 * L::KTILE);
        for (int part = 0; part < 2; ++part)
          for (int j = 0; j < L::ATOMS; ++j)
            tma_load_3d(st + part * L::KTILE + j * L::K_ATOM, &tk, col0 + 32 * j, t * BN,
                        2 * kvh + part, full_k(s));
        mbar_wait(empty_v(s), vacant);
        mbar_expect_tx(full_v(s), 2 * L::VTILE);
        for (int part = 0; part < 2; ++part)
          tma_load_3d(st + 2 * L::KTILE + part * L::VTILE, &tv, t * BN, col0, 2 * kvh + part,
                      full_v(s));
      }
    }
  } else {
    // ===== consumer warpgroup: 64 q rows =====
    const int lane = threadIdx.x & 31;
    const int row0 = q0 + (threadIdx.x >> 5) * 16 + (lane >> 2);  // and row0 + 8
    const int c2 = (lane & 3) * 2;

    // Split Q in place: hi stays where TMA put it, lo goes to QL at the
    // same (swizzled) offset. Then make the generic-proxy writes visible
    // to wgmma's async proxy before any consumer reads them.
    mbar_wait(q_full, 0);
    {
      float4* qh = reinterpret_cast<float4*>(gbase + L::QH);
      float4* ql = reinterpret_cast<float4*>(gbase + L::QL);
      const int n4 = L::ATOMS * L::Q_ATOM / 16;
      for (int i = threadIdx.x; i < n4; i += CONSUMER_THREADS) {
        const float4 x = qh[i];
        float4 hi, lo;
        split(x.x, hi.x, lo.x);
        split(x.y, hi.y, lo.y);
        split(x.z, hi.z, lo.z);
        split(x.w, hi.w, lo.w);
        qh[i] = hi;
        ql[i] = lo;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMER_THREADS) : "memory");
    }

    float acc[NB][32];
    float acc_t[16];  // the 32-column tail block (TAIL only)
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) acc_t[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};  // running max, log2 domain
    float l[2] = {0.f, 0.f};          // this thread's share of the running sum
    float sc[16];                     // one tile's scores, then its P
    uint32_t ph[4][4], pl[4][4];      // P as tf32 A fragments, hi and lo
    float alpha[2];

    auto fence_acc = [&]() {
#pragma unroll
      for (int j = 0; j < NB; ++j) fence_regs(acc[j]);
      if constexpr (TAIL) fence_regs(acc_t);
    };

    // S = Q K^T of the tile in stage s: three products over DPH / 8 k8
    // steps (the columns past D are TMA's zeros), small terms first.
    auto issue_qk = [&](int s) {
      const uint32_t st = base + L::RING + s * L::STAGE;
      wgmma_fence();
#pragma unroll
      for (int term = 0; term < 3; ++term) {
        const uint32_t qa = base + (term == 0 ? L::QL : L::QH);
        const uint32_t kb = st + (term == 1 ? L::KTILE : 0);
#pragma unroll
        for (int j = 0; j < L::ATOMS; ++j)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_n32(sc, desc_sw128(qa + j * L::Q_ATOM + kk * 32),
                         desc_sw128(kb + j * L::K_ATOM + kk * 32), (term | j | kk) != 0);
      }
      wgmma_commit();
    };

    // O += P V of the tile in stage s: three products, small terms first;
    // V^T's N-blocks of 64 head-dim rows are 8 KB apart, its k8 slices 32
    // bytes.
    auto issue_pv = [&](int s) {
      const uint32_t st = base + L::RING + s * L::STAGE;
      fence_acc();
      wgmma_fence();
#pragma unroll
      for (int term = 0; term < 3; ++term) {
        const uint32_t vb = st + 2 * L::KTILE + (term == 1 ? L::VTILE : 0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < NB; ++j)
            wgmma_rs_n64(acc[j], term == 0 ? pl[i] : ph[i],
                         desc_sw128(vb + j * 64 * ROW + i * 32));
          if constexpr (TAIL)
            wgmma_rs_n32(acc_t, term == 0 ? pl[i] : ph[i],
                         desc_sw128(vb + NB * 64 * ROW + i * 32));
        }
      }
      wgmma_commit();
    };

    // A pair's scores: this block's partial (its DPH columns of the head
    // dim) goes to the peer's exchange buffer b, slot threadIdx.x, and the
    // peer's partial for the same elements is added from this block's
    // once its EXCHANGE bytes have landed. Thread 0 expects them (the
    // barrier's one arrival); bytes that land first leave the
    // transaction count below 0 until it does.
    auto exchange = [&](int n) {
      const int bsel = n & 1;
      const uint32_t mine = base + L::XCHG + bsel * EXCHANGE + threadIdx.x * 16;
      const uint32_t theirs = peer_addr(mine, rank ^ 1);
      const uint32_t their_bar = peer_addr(xchg_full(bsel), rank ^ 1);
      if (threadIdx.x == 0) mbar_expect_tx(xchg_full(bsel), EXCHANGE);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        st_async(theirs + j * CONSUMER_THREADS * 16, sc[4 * j], sc[4 * j + 1], sc[4 * j + 2],
                 sc[4 * j + 3], their_bar);
      mbar_wait(xchg_full(bsel), (n >> 1) & 1);
      const float4* in = reinterpret_cast<const float4*>(gbase + (mine - base));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 x = in[j * CONSUMER_THREADS];
        sc[4 * j] += x.x;
        sc[4 * j + 1] += x.y;
        sc[4 * j + 2] += x.z;
        sc[4 * j + 3] += x.w;
      }
    };

    // Scores of the tile at kv row k0 -> P in place, alpha, m and l: scale
    // into the log2 domain, mask only where the tile straddles the
    // diagonal, the window edge or Sk, then the online softmax in the
    // Pallas order for rows row0 and row0 + 8.
    auto softmax = [&](int k0) {
      const bool edge = (causal && k0 + BN - 1 > g0) || k0 + BN > Sk ||
                        (has_window && k0 <= g0 + BM - 1 - window);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * i + e] * scale_log2;
          if (edge) {
            const int col = k0 + 8 * i + c2 + (e & 1);
            const int row = q_off + row0 + 8 * (e >> 1);
            bool keep = col < Sk;
            if (causal) keep = keep && col <= row;
            if (has_window) keep = keep && col > row - window;
            x = keep ? x : NEG_INF;
          }
          sc[4 * i + e] = x;
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = m[hh];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          mx = fmaxf(mx, fmaxf(sc[4 * i + 2 * hh], sc[4 * i + 2 * hh + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        alpha[hh] = exp2_approx(m[hh] - mx);
        m[hh] = mx;
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2_approx(sc[4 * i + 2 * hh + e] - mx);
            sc[4 * i + 2 * hh + e] = p;
            sum += p;
          }
        l[hh] = alpha[hh] * l[hh] + sum;
      }
    };

    // P (registers {4i, 4i+2, 4i+1, 4i+3} for k8 slice i) -> hi/lo fragments.
    auto split_p = [&]() {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float frag[4] = {sc[4 * i], sc[4 * i + 2], sc[4 * i + 1], sc[4 * i + 3]};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float hi, lo;
          split(frag[r], hi, lo);
          ph[i][r] = __float_as_uint(hi);
          pl[i][r] = __float_as_uint(lo);
        }
      }
    };

    // Software pipeline over the tiles: while the tensor cores run tile
    // n - 1's P V, the softmax of tile n (whose Q K^T was issued first)
    // runs on the CUDA cores. A K stage is released once its Q K^T is
    // done, a V stage once its P V is, so the producer refills K a whole
    // tile ahead.
    const int tiles = t1 - t0;
    if (tiles > 0) {
      mbar_wait(full_k(0), 0);
      issue_qk(0);
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(empty_k(0));
      if constexpr (PAIR) exchange(0);
      softmax(t0 * BN);  // alpha scales an acc of zeros: not applied
      split_p();
      for (int n = 1; n < tiles; ++n) {
        const int s = n % STAGES;
        const int sp = (n - 1) % STAGES;
        mbar_wait(full_k(s), (n / STAGES) & 1);
        issue_qk(s);
        mbar_wait(full_v(sp), ((n - 1) / STAGES) & 1);
        issue_pv(sp);
        wgmma_wait<1>();  // Q K^T of tile n is done; P V of n - 1 may run on
        fence_regs(sc);
        mbar_arrive(empty_k(s));
        if constexpr (PAIR) exchange(n);
        softmax((t0 + n) * BN);
        wgmma_wait<0>();
        fence_acc();
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          fence_regs(ph[i]);
          fence_regs(pl[i]);
        }
        mbar_arrive(empty_v(sp));
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[j][i] *= alpha[(i >> 1) & 1];
        if constexpr (TAIL) {
#pragma unroll
          for (int i = 0; i < 16; ++i) acc_t[i] *= alpha[(i >> 1) & 1];
        }
        split_p();
      }
      const int sl = (tiles - 1) % STAGES;
      mbar_wait(full_v(sl), ((tiles - 1) / STAGES) & 1);
      issue_pv(sl);
      wgmma_wait<0>();
      fence_acc();
      mbar_arrive(empty_v(sl));
    }

    // O / l, with a zero row where the sum is 0; rows past Sq and the
    // padded columns past D are not stored; a pair's block stores its
    // own DPH columns.
    float den[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float sum = l[hh];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      den[hh] = sum == 0.f ? 1.f : sum;
    }
    float* op = o + (size_t)bh * Sq * D;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      if (row >= Sq) continue;
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int col = col0 + 64 * j + 8 * i + c2;
          if (col < D)
            *reinterpret_cast<float2*>(op + (size_t)row * D + col) =
                make_float2(acc[j][4 * i + 2 * hh] / den[hh],
                            acc[j][4 * i + 2 * hh + 1] / den[hh]);
        }
      if constexpr (TAIL) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = col0 + 64 * NB + 8 * i + c2;
          if (col < D)
            *reinterpret_cast<float2*>(op + (size_t)row * D + col) =
                make_float2(acc_t[4 * i + 2 * hh] / den[hh], acc_t[4 * i + 2 * hh + 1] / den[hh]);
        }
      }
    }
  }
  if constexpr (PAIR) cluster_sync();
}

// ---- host side ------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime, so the
// library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D f32 view (inner, rows, planes) of a contiguous tensor, loaded as
// (32, box_rows, 1) boxes with the 128-byte swizzle; out-of-range
// elements read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int inner, int rows, int planes,
              int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * 4, (cuuint64_t)rows * inner * 4};
  const cuuint32_t box[3] = {32, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One block per (b h, q tile), or with PAIR a cluster of two blocks
// along x, each holding DPH head-dim columns. A pair that cannot be
// scheduled (or too much shared memory) fails the launch with its error.
template <int DPH, bool PAIR>
cudaError_t launch(const void* q, const void* ks, const void* vt, float* o, int B, int H,
                   int Hkv, int Sq, int Sk, int q_off, int D, int Sp, int causal,
                   int has_window, int window, float scale_log2, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, D, Sq, B * H, BM) || !make_map(&tk, ks, D, Sk, 2 * B * Hkv, BN) ||
      !make_map(&tv, vt, Sp, D, 2 * B * Hkv, DPH))
    return cudaErrorInvalidValue;
  auto kern = flash_fwd_tf32x3_kernel<DPH, PAIR>;
  const int smem = Smem<DPH, PAIR>::ALLOC;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)(B * H * (PAIR ? 2 : 1)), (unsigned)((Sq + BM - 1) / BM));
  if constexpr (!PAIR) {
    kern<<<grid, THREADS, smem, st>>>(tq, tk, tv, o, H, Hkv, Sq, Sk, q_off, D, causal,
                                      has_window, window, scale_log2);
    return cudaGetLastError();
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 2;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    void* args[] = {&tq, &tk, &tv, &o, &H, &Hkv, &Sq, &Sk, &q_off, &D, &causal, &has_window,
                    &window, &scale_log2};
    e = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kern), args);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
  }
}

}  // namespace

// q (B, H, Sq, D), k and v (B, Hkv, Sk, D) and o are contiguous f32 and
// 16-byte aligned; o has q's shape; q's rows are rows q_off .. q_off +
// Sq - 1 of the sequence the masks read; ks is scratch of (B * Hkv, 2,
// Sk, D) f32 and vt of (B * Hkv, 2, D, Sp) f32 with Sp = Sk rounded up to
// a multiple of 32; D is a multiple of 8 in [8, 256]. Launches the split
// pre-pass, then the attention kernel, on `stream`. Returns the CUDA
// error of the launches (0 on success).
extern "C" int flash_attention_f32_sm90_launch(const void* q, const void* k, const void* v,
                                               void* o, void* ks, void* vt, int B, int H,
                                               int Hkv, int Sq, int Sk, int q_off, int D,
                                               int causal, int has_window, int window,
                                               float scale, void* stream) {
  if (B < 0 || H <= 0 || Hkv <= 0 || H % Hkv || Sq < 0 || Sk < 0 || q_off < 0 || D < 8 ||
      D > MAX_D || D % 8)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o | (uintptr_t)ks |
       (uintptr_t)vt) & 15)
    return (int)cudaErrorMisalignedAddress;
  if ((Sq + BM - 1) / BM > 65535 || B * Hkv > 65535 || (long long)B * H * 2 > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Sp = (Sk + 31) / 32 * 32;
  const dim3 grid_split((unsigned)(Sp / 32), (unsigned)((D + 31) / 32), (unsigned)(B * Hkv));
  tf32x3_split_kernel<<<grid_split, 256, 0, st>>>(
      static_cast<const float*>(k), static_cast<const float*>(v), static_cast<float*>(ks),
      static_cast<float*>(vt), Sk, D, Sp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const float scale_log2 = scale * LOG2E;
  float* out = static_cast<float*>(o);
#define LAUNCH(DPH, PAIR)                                                                  \
  return (int)launch<DPH, PAIR>(q, ks, vt, out, B, H, Hkv, Sq, Sk, q_off, D, Sp, causal, \
                                has_window, window, scale_log2, st)
  if (D <= 64) LAUNCH(64, false);
  if (D <= 128) LAUNCH(128, false);
  if (D <= 192) LAUNCH(96, true);
  LAUNCH(128, true);
#undef LAUNCH
}
