// Forward flash attention (online softmax, GQA, causal and sliding-window
// masks) for Hopper.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:flash_attention_pallas
// (body _flash_kernel). Same semantics: q (B, H, S, D), k and v
// (B, Hkv, S, D); query head h reads kv head h / (H / Hkv); masks
// col <= row (causal) and col > row - window; f32 running max, running
// sum and accumulator; the finite sentinel -1e30 (not -inf) for masked
// scores; a row whose sum is 0 outputs 0; output in q's dtype.
//
// Route "simt" of ops._route: what the two tensor-core kernels do not
// take — f32 with D above 128 (csrc/flash_attention_f32_sm90.cu, 3xTF32,
// takes f32 up to 128) and bf16/f16 with D not a multiple of 16
// (csrc/flash_attention_sm90.cu takes the rest). It does its products on
// the CUDA cores in f32 (no wgmma, no TMA), so its floor is the f32
// CUDA-core rate: 4 * D * H * S(S+1)/2 flops over 67 TFLOP/s.
//
// Design: the TPU kernel walks kv blocks as the innermost *sequential*
// grid axis and carries acc/m/l in VMEM scratch across grid steps. On
// Hopper blocks run in parallel with nothing carried between them, so
// one block owns one (b*H + h, 64-row q tile) and a loop inside the
// block walks the kv tiles. Each kv tile (64 rows) is staged once in
// shared memory, converted to f32 on load, straight from kv head
// h / group — never repeated per query head. Eight warps each own eight
// q rows; a lane owns two score columns (lane, lane + 32) and D/32
// accumulator columns, so row max and row sum are warp shuffles and P.V
// broadcasts each probability with one shuffle. K rows are padded by one
// float so the lanes' column reads hit distinct banks. Tiles that are
// fully masked for the whole q tile are skipped; the ragged edge (S not
// a multiple of 64) is masked, so the tile sizes need not divide S.
// Keeping the finite -1e30 sentinel and the Pallas rescaling order makes
// a tile that is masked for one row but kept for the block add nothing
// once a real score arrives (exp(-1e30 - m) == 0), where -inf would give
// NaN.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;               // q rows per block
constexpr int BK = 64;               // kv rows per staged tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = BQ / WARPS;     // q rows per warp
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load_f32(const __half* p) { return __half2float(*p); }

__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store_f32(__half* p, float x) { *p = __float2half_rn(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

// DC = ceil(D / 32): accumulator columns per lane.
template <typename T, int DC>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int Hkv, int S,
                 int D, int causal, int has_window, int window, float scale) {
  extern __shared__ float smem[];
  const int ldk = D + 1;
  float* qs = smem;              // BQ x D
  float* ks = qs + BQ * D;       // BK x (D + 1)
  float* vs = ks + BK * ldk;     // BK x D

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = b * Hkv + h / (H / Hkv);
  const int q0 = blockIdx.y * BQ;
  const size_t SD = (size_t)S * D;
  const T* qp = q + (size_t)bh * SD + (size_t)q0 * D;
  const T* kp = k + (size_t)kvh * SD;
  const T* vp = v + (size_t)kvh * SD;
  T* op = o + (size_t)bh * SD;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * ROWS;  // this warp's first row in the tile

  for (int i = tid; i < BQ * D; i += THREADS) {
    qs[i] = q0 + i / D < S ? load_f32(qp + i) : 0.f;
  }

  float m[ROWS], l[ROWS], acc[ROWS][DC];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }
  const int q_last = min(q0 + BQ, S) - 1;

  for (int k0 = 0; k0 < S; k0 += BK) {
    const int k_last = min(k0 + BK, S) - 1;
    // Tile relevance for the whole q tile (uniform across the block).
    if (causal && k0 > q_last) break;
    if (has_window && k_last <= q0 - window) continue;

    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int c = i / D;
      const int d = i - c * D;
      const bool in = k0 + c < S;
      ks[c * ldk + d] = in ? load_f32(kp + (size_t)k0 * D + i) : 0.f;
      vs[i] = in ? load_f32(vp + (size_t)k0 * D + i) : 0.f;
    }
    __syncthreads();

    // Scores: this lane's columns lane and lane + 32, for the warp's rows.
    float s[ROWS][2];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r][0] = s[r][1] = 0.f;
    const float* ka = ks + lane * ldk;
    const float* kb = ks + (lane + 32) * ldk;
    const float* qw = qs + r0 * D;
    for (int d = 0; d < D; ++d) {
      const float a = ka[d];
      const float bb = kb[d];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float qv = qw[r * D + d];
        s[r][0] = fmaf(qv, a, s[r][0]);
        s[r][1] = fmaf(qv, bb, s[r][1]);
      }
    }

    // Mask, then the online-softmax update in the Pallas kernel's order.
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int row = q0 + r0 + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = k0 + lane + 32 * j;
        bool keep = col < S;
        if (causal) keep = keep && col <= row;
        if (has_window) keep = keep && col > row - window;
        s[r][j] = keep ? s[r][j] * scale : NEG_INF;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      const float alpha = expf(m[r] - m_new);
      s[r][0] = expf(s[r][0] - m_new);
      s[r][1] = expf(s[r][1] - m_new);
      l[r] = alpha * l[r] + warp_sum(s[r][0] + s[r][1]);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= alpha;
    }

    // acc += P . V: column `src + 32 j` of P lives in lane `src`.
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll 4
      for (int src = 0; src < 32; ++src) {
        const float* vrow = vs + (j * 32 + src) * D;
        float vv[DC];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int d = lane + 32 * c;
          vv[c] = d < D ? vrow[d] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float p = __shfl_sync(FULL, s[r][j], src);
#pragma unroll
          for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = q0 + r0 + r;
    if (row >= S) continue;
    const float lr = l[r] == 0.f ? 1.f : l[r];  // fully masked row -> 0
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) store_f32(op + (size_t)row * D + d, acc[r][c] / lr);
    }
  }
}

template <typename T, int DC>
cudaError_t launch_dc(const void* q, const void* k, const void* v, void* o, int B,
                      int H, int Hkv, int S, int D, int causal, int has_window,
                      int window, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)(BQ * D + BK * (D + 1) + BK * D) * sizeof(float);
  auto kern = flash_fwd_kernel<T, DC>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)(B * H), (unsigned)((S + BQ - 1) / BQ));
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, Hkv, S, D, causal, has_window, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v, void* o, int B, int H,
                     int Hkv, int S, int D, int causal, int has_window, int window,
                     float scale, cudaStream_t st) {
  switch ((D + 31) / 32) {
#define CASE(DC)                                                                    \
  case DC:                                                                          \
    return launch_dc<T, DC>(q, k, v, o, B, H, Hkv, S, D, causal, has_window, window, \
                            scale, st);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. q, k, v and o are
// contiguous; o has q's shape and dtype. Returns the CUDA error of the
// launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int B, int H, int Hkv, int S, int D,
                                      int causal, int has_window, int window,
                                      float scale, int dtype, void* stream) {
  if (B < 0 || H <= 0 || Hkv <= 0 || H % Hkv || S < 0 || D < 8 || D > 256 || D % 8)
    return (int)cudaErrorInvalidValue;
  if ((S + BQ - 1) / BQ > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_t<float>(q, k, v, o, B, H, Hkv, S, D, causal, has_window, window,
                                  scale, st);
    case 1:
      return (int)launch_t<__nv_bfloat16>(q, k, v, o, B, H, Hkv, S, D, causal, has_window,
                                          window, scale, st);
    case 2:
      return (int)launch_t<__half>(q, k, v, o, B, H, Hkv, S, D, causal, has_window, window,
                                   scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
