// Forward flash attention on Hopper's tensor cores: wgmma products, TMA
// loads, one producer warpgroup and one consumer warpgroup per block.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:flash_attention_pallas
// (body _flash_kernel) for bf16/f16 inputs whose head dim D is a multiple
// of 8 in [8, 256]; f32 takes csrc/flash_attention_f32_sm90.cu.
// Same semantics as the Pallas kernel: q (B, H, Sq, D), k and v
// (B, Hkv, Sk, D); query head h reads kv head h / (H / Hkv); masks
// col <= row (causal) and col > row - window, where q's row i is row
// q_off + i of the sequence (Sq = Sk and q_off = 0 is the Pallas
// kernel's square call; a sequence-sharded rank's block of query rows
// passes its offset and the whole K/V); f32 running max, running
// sum and accumulator; the finite sentinel -1e30 (never -inf) for masked
// scores, with the Pallas order m_new = max(m, rowmax), alpha =
// exp(m - m_new), p = exp(s - m_new), l = alpha l + sum p, acc = alpha acc
// + p V; a row whose sum is 0 outputs 0; output in q's dtype.
//
// Bound on the H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): causal prefill
// does 4 D H S(S+1)/2 flops over (2H + 2Hkv) S D 2 bytes, so at D = 128
// the operations floor overtakes the bytes floor from S ~ 600 on: at the
// serve shape (yi-6b heads, S = 512) both floors are ~2.5 us, at S = 4096
// the 137 GFLOP take 139 us against 22 us of bytes. The kernel is built
// to feed the tensor cores:
//
// * Both products are wgmma m64n64k16 with f32 accumulators in registers:
//   S = Q K^T with Q and K read from shared memory (K-major), and
//   O += P V with P in registers (the S accumulator layout is the A
//   fragment layout, so P is converted to 16 bits in place) and V read
//   from shared memory as an MN-major (transposed) B operand. A 64-wide
//   column block of the head dim is one 128-byte swizzle atom, so every
//   descriptor spans exactly one atom across N; D is padded to DP, a
//   multiple of 64, with zeros that TMA fills in. A head dim of 8 mod 16
//   (row stride D * 2 bytes, a multiple of TMA's 16) pads the same way:
//   D = 40 computes 64 columns, 1.6x its work, and stores the 40 (pairs
//   of columns (2c, 2c + 1) never straddle D when D % 8 == 0).
// * Q arrives once by TMA; K and V tiles (64 rows) arrive through a
//   2-stage ring by TMA with full/empty mbarriers, straight from kv head
//   h / group, 16-bit and 128-byte swizzled in shared memory. K and V
//   have separate full barriers, so S = Q K^T starts before V has landed.
// * One thread of the producer warpgroup (setmaxnreg.dec to 24) issues
//   the loads; the consumer warpgroup (setmaxnreg.inc to 232) owns 64 q
//   rows, does the online softmax in registers (row max by two shuffles
//   across the quad of threads sharing a row; row sums kept per thread
//   and reduced once at the end) and rescales O by alpha before each P V.
// * Tensor maps are 3-D (D, S, heads), so rows past S load as zeros and
//   never read into the next head. Fully masked kv tiles are skipped;
//   element masks run only on tiles that straddle the diagonal, the
//   window edge or S.
// * Blocks walk q tiles from the last one down, so the longest causal
//   rows are scheduled first and the last wave holds the short ones.
//
// Left for later: two consumer warpgroups (128 q rows per block, one
// warpgroup's softmax hidden under the other's wgmma), overlap of the
// next tile's Q K^T with this tile's softmax inside one warpgroup, and a
// TMA store of O.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int BM = 64;  // q rows per block (one consumer warpgroup)
constexpr int BN = 64;  // kv rows per ring stage
constexpr int STAGES = 2;
constexpr int CONSUMER_THREADS = 128;
// The producer is a whole warpgroup, of which one thread issues the
// loads: setmaxnreg acts on whole warpgroups, and with a lone producer
// warp the consumers' setmaxnreg.inc never returns on an H100.
constexpr int THREADS = CONSUMER_THREADS + 128;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 232;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int ATOM = 64 * 128;  // 64 rows x 128 bytes: one swizzled column block

// Shared memory of one block, as byte offsets from a 1024-aligned base.
template <int DP>
struct Smem {
  static constexpr int BLOCKS = DP / 64;        // column blocks of the head dim
  static constexpr int TILE = BLOCKS * ATOM;    // one 64 x DP tile
  static constexpr int Q = 0;
  static constexpr int K = TILE;                // stage s at K + s * TILE
  static constexpr int V = K + STAGES * TILE;
  static constexpr int BAR = V + STAGES * TILE;  // full_k[], full_v[], empty[], q_full
  static constexpr int BYTES = BAR + (3 * STAGES + 1) * 8;
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

// Wait for the phase of parity `parity` to complete. A wait that lasts
// billions of cycles means a lost transaction: trap, so the launch fails
// with an error instead of hanging the card.
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

// Shared-memory matrix descriptor for a 128-byte-swizzled operand whose
// extent across the 128-byte rows is one swizzle atom: both byte offsets
// are the 1024-byte step between groups of 8 rows (the only stride such
// an operand uses, in K-major and in MN-major form alike).
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
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of wgmma operands across
// the asynchronous window between issue and wait.
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

#define ACC32(d)                                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),      \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),   \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),   \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),   \
      "+f"(d[31])
#define REGS32                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, " \
  "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64, f32) (+)= A (64 x 16, shared, K-major) . B (16 x 64, shared,
// K-major); scale_d = 0 overwrites d.
#define DEFINE_WGMMA_SS(NAME, TY)                                                     \
  __device__ __forceinline__ void NAME(float (&d)[32], uint64_t da, uint64_t db,      \
                                       int scale_d) {                                 \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                        \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " REGS32 \
                 ", %32, %33, p, 1, 1, 0, 0;\n}\n"                                    \
                 : ACC32(d)                                                           \
                 : "l"(da), "l"(db), "r"(scale_d));                                   \
  }

// d (64 x 64, f32) += A (64 x 16, registers) . B (16 x 64, shared,
// MN-major: B's rows of 64 contiguous values are its K index).
#define DEFINE_WGMMA_RS(NAME, TY)                                                      \
  __device__ __forceinline__ void NAME(float (&d)[32], const uint32_t (&a)[4],         \
                                       uint64_t db) {                                  \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                         \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " REGS32   \
                 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                       \
                 : ACC32(d)                                                            \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));       \
  }

DEFINE_WGMMA_SS(wgmma_ss_bf16, "bf16")
DEFINE_WGMMA_SS(wgmma_ss_f16, "f16")
DEFINE_WGMMA_RS(wgmma_rs_bf16, "bf16")
DEFINE_WGMMA_RS(wgmma_rs_f16, "f16")

template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    wgmma_ss_bf16(d, da, db, scale_d);
  } else {
    wgmma_ss_f16(d, da, db, scale_d);
  }
}

template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    wgmma_rs_bf16(d, a, db);
  } else {
    wgmma_rs_f16(d, a, db);
  }
}

// ---- numerics ----------------------------------------------------------------

__device__ __forceinline__ float exp2_approx(float x) {  // exp2(-1e30) == 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats as one 32-bit register of 16-bit values, the lower column low.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float lo, float hi) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
  } else {
    *reinterpret_cast<__half2*>(p) = __floats2half2_rn(lo, hi);
  }
}

// ---- the kernel ----------------------------------------------------------------

// Accumulator layout of wgmma m64nN (f32), thread t of the warpgroup:
// warp w = t / 32 owns rows 16 w .. 16 w + 15; with g = (t % 32) / 4 and
// c = 2 (t % 4), register 4 i + e holds row 16 w + g + 8 (e / 2), column
// 8 i + c + (e % 2). Registers 8 k .. 8 k + 7 of the scores are then
// exactly the A fragment of P for the k-th 16-column slice.
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, T* __restrict__ o, int H,
                      int Hkv, int Sq, int Sk, int q_off, int D, int causal, int has_window,
                      int window, float scale_log2) {
  using L = Smem<DP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar = base + L::BAR;
  auto full_k = [&](int s) { return bar + 8u * s; };
  auto full_v = [&](int s) { return bar + 8u * (STAGES + s); };
  auto empty = [&](int s) { return bar + 8u * (2 * STAGES + s); };
  const uint32_t q_full = bar + 8u * (3 * STAGES);

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // longest causal tiles first
  const int b = bh / H;
  const int kvh = b * Hkv + (bh - b * H) / (H / Hkv);

  // The kv tiles this q tile needs, [t0, t1): the same walk for the
  // producer and the consumers. g0 and g_last are the tile's first and
  // last rows in the sequence.
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
      mbar_init(empty(s), CONSUMER_THREADS);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMER_THREADS) {
    // ===== producer warpgroup: every load of the block, from one thread =====
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMER_THREADS) {
      mbar_expect_tx(q_full, L::TILE);
#pragma unroll
      for (int j = 0; j < L::BLOCKS; ++j)
        tma_load_3d(base + L::Q + j * ATOM, &tq, 64 * j, q0, bh, q_full);
      for (int t = t0, n = 0; t < t1; ++t, ++n) {
        const int s = n % STAGES;
        mbar_wait(empty(s), ((n / STAGES) & 1) ^ 1);
        mbar_expect_tx(full_k(s), L::TILE);
#pragma unroll
        for (int j = 0; j < L::BLOCKS; ++j)
          tma_load_3d(base + L::K + s * L::TILE + j * ATOM, &tk, 64 * j, t * BN, kvh,
                      full_k(s));
        mbar_expect_tx(full_v(s), L::TILE);
#pragma unroll
        for (int j = 0; j < L::BLOCKS; ++j)
          tma_load_3d(base + L::V + s * L::TILE + j * ATOM, &tv, 64 * j, t * BN, kvh,
                      full_v(s));
      }
    }
  } else {
    // ===== consumer warpgroup: 64 q rows =====
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int lane = threadIdx.x & 31;
    const int row0 = q0 + (threadIdx.x >> 5) * 16 + (lane >> 2);  // and row0 + 8
    const int c2 = (lane & 3) * 2;

    float acc[L::BLOCKS][32];
#pragma unroll
    for (int j = 0; j < L::BLOCKS; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};  // running max, log2 domain
    float l[2] = {0.f, 0.f};          // this thread's share of the running sum

    mbar_wait(q_full, 0);
    for (int t = t0, n = 0; t < t1; ++t, ++n) {
      const int s = n % STAGES;
      const uint32_t parity = (n / STAGES) & 1;
      const uint32_t ks = base + L::K + s * L::TILE;
      const uint32_t vs = base + L::V + s * L::TILE;

      // S = Q K^T over DP / 16 slices of the head dim.
      float sc[32];
      mbar_wait(full_k(s), parity);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < L::BLOCKS; ++j)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<T>(sc, desc_sw128(base + L::Q + j * ATOM + kk * 32),
                      desc_sw128(ks + j * ATOM + kk * 32), (j | kk) != 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // Scale into the log2 domain; mask only where the tile straddles
      // the diagonal, the window edge or Sk.
      const int k0 = t * BN;
      const bool edge = (causal && k0 + BN - 1 > g0) || k0 + BN > Sk ||
                        (has_window && k0 <= g0 + BM - 1 - window);
#pragma unroll
      for (int i = 0; i < 8; ++i)
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

      // Online softmax, in the Pallas order, for rows row0 and row0 + 8.
      float alpha[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = m[hh];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          mx = fmaxf(mx, fmaxf(sc[4 * i + 2 * hh], sc[4 * i + 2 * hh + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        alpha[hh] = exp2_approx(m[hh] - mx);
        m[hh] = mx;
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2_approx(sc[4 * i + 2 * hh + e] - mx);
            sc[4 * i + 2 * hh + e] = p;
            sum += p;
          }
        l[hh] = alpha[hh] * l[hh] + sum;
      }
#pragma unroll
      for (int j = 0; j < L::BLOCKS; ++j)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[j][i] *= alpha[(i >> 1) & 1];

      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack2<T>(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

      // O += P V: V's 16-row slices are 2048 bytes apart in every
      // column block.
      mbar_wait(full_v(s), parity);
#pragma unroll
      for (int j = 0; j < L::BLOCKS; ++j) fence_regs(acc[j]);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < L::BLOCKS; ++j)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<T>(acc[j], pa[kk], desc_sw128(vs + j * ATOM + kk * 2048));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int j = 0; j < L::BLOCKS; ++j) fence_regs(acc[j]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
      mbar_arrive(empty(s));
    }

    // O / l, with a zero row where the sum is 0; rows past Sq and the
    // padded columns past D are not stored.
    float den[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float sum = l[hh];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      den[hh] = sum == 0.f ? 1.f : sum;
    }
    T* op = o + (size_t)bh * Sq * D;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      if (row >= Sq) continue;
#pragma unroll
      for (int j = 0; j < L::BLOCKS; ++j)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int col = 64 * j + 8 * i + c2;
          if (col < D)
            store2<T>(op + (size_t)row * D + col, acc[j][4 * i + 2 * hh] / den[hh],
                      acc[j][4 * i + 2 * hh + 1] / den[hh]);
        }
    }
  }
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

// A (D, S, heads) view of a contiguous (heads, S, D) tensor, loaded as
// 64 x 64 boxes with the 128-byte swizzle; out-of-range elements read
// as zeros.
bool make_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType ty, int D, int S,
              int heads) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)BN, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, ty, 3, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int DP>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                   void* o, int B, int H, int Hkv, int Sq, int Sk, int q_off, int D,
                   int causal, int has_window, int window, float scale_log2,
                   cudaStream_t st) {
  auto kern = flash_fwd_sm90_kernel<T, DP>;
  // setmaxnreg moves registers inside the block: the consumers' gain must
  // fit in what the producer warpgroup gives back, or setmaxnreg.inc would
  // wait forever. Refuse the launch instead.
  static int regs = -1;
  if (regs < 0) {
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, kern);
    if (e != cudaSuccess) return e;
    regs = attr.numRegs;
  }
  if (regs > CONSUMER_REGS ||
      CONSUMER_THREADS * (CONSUMER_REGS - regs) > (THREADS - CONSUMER_THREADS) * (regs - PRODUCER_REGS))
    return cudaErrorLaunchOutOfResources;
  const int smem = Smem<DP>::ALLOC;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)(B * H), (unsigned)((Sq + BM - 1) / BM));
  kern<<<grid, THREADS, smem, st>>>(tq, tk, tv, static_cast<T*>(o), H, Hkv, Sq, Sk, q_off, D,
                                    causal, has_window, window, scale_log2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                     void* o, int B, int H, int Hkv, int Sq, int Sk, int q_off, int D,
                     int causal, int has_window, int window, float scale_log2,
                     cudaStream_t st) {
  switch ((D + 63) / 64) {
#define CASE(N)                                                                     \
  case N:                                                                           \
    return launch<T, 64 * N>(tq, tk, tv, o, B, H, Hkv, Sq, Sk, q_off, D, causal,   \
                             has_window, window, scale_log2, st);
    CASE(1) CASE(2) CASE(3) CASE(4)
#undef CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 1 = bfloat16, 2 = float16. q (B, H, Sq, D), k and v (B, Hkv, Sk,
// D) and o are contiguous and 16-byte aligned; o has q's shape and dtype;
// D is a multiple of 8 in [8, 256]; q's rows are rows q_off .. q_off +
// Sq - 1 of the sequence the masks read. Returns the CUDA error of the
// launch (0 on success).
extern "C" int flash_attention_sm90_launch(const void* q, const void* k, const void* v,
                                           void* o, int B, int H, int Hkv, int Sq, int Sk,
                                           int q_off, int D, int causal, int has_window,
                                           int window, float scale, int dtype,
                                           void* stream) {
  if (B < 0 || H <= 0 || Hkv <= 0 || H % Hkv || Sq < 0 || Sk < 0 || q_off < 0 || D < 8 ||
      D > 256 || D % 8)
    return (int)cudaErrorInvalidValue;
  if (dtype != 1 && dtype != 2) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) & 15)
    return (int)cudaErrorMisalignedAddress;
  if ((Sq + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  const CUtensorMapDataType ty =
      dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, ty, D, Sq, B * H) || !make_map(&tk, k, ty, D, Sk, B * Hkv) ||
      !make_map(&tv, v, ty, D, Sk, B * Hkv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * LOG2E;
  if (dtype == 1)
    return (int)launch_t<__nv_bfloat16>(tq, tk, tv, o, B, H, Hkv, Sq, Sk, q_off, D, causal,
                                        has_window, window, scale_log2, st);
  return (int)launch_t<__half>(tq, tk, tv, o, B, H, Hkv, Sq, Sk, q_off, D, causal, has_window,
                               window, scale_log2, st);
}
