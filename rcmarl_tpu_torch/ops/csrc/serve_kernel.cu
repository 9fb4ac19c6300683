// The serve kernel: row-stacked actor forward, softmax, per-request
// threefry keys and the gumbel-argmax sample, in one launch.
//
// Replaces the TPU kernel rcmarl_tpu/ops/pallas_serve.py:_serve_kernel
// (launched by _fused_serve through fused_serve_block and
// fused_fleet_block). It computes the same function, not the same
// blocks: one CTA per (batch tile, agent n); the tile's activations
// ping-pong between two shared-memory buffers, layer after layer, and
// only the actions and probabilities reach device memory.
//
// What bounds it on an H100: at the reference widths (5 agents, 20-wide
// layers) the bytes (observations in, probabilities out) and the launch
// itself; at the 256-wide, 64-agent configuration the float32 FMAs
// (about 86 GFLOP for 4096 requests, CUDA cores, no tensor cores). The
// weights of one layer (256 KiB at 256x256 in float32) do not fit a
// CTA's shared memory, so they are read through the read-only path
// (__ldg) and each weight load is reused across RB rows held in
// registers; the bf16 mode rounds both operands with
// __float2bfloat16_rn and accumulates in float32, which is what the
// JAX package's bf16 dot computes.
//
// Sampling is bitwise jax.random: key_bn = fold_in(fold_in(key, b), n),
// the partitionable bits layout (bits[a] = o0 ^ o1 of
// threefry2x32(key_bn, (0, a))), the mantissa-fill uniform on [tiny, 1),
// gumbel = -log(-log(u)) and argmax(gumbel + log(probs)), first index on
// ties. expf/logf are the accurate ones: the file is built without
// --use_fast_math.
//
// Built by rcmarl_tpu_torch/ops/cuda_serve.py with nvcc for sm_90a into a
// shared library with a plain C interface.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define MAX_LAYERS 8
#define THREADS 256
#define RB 16  // rows per thread in the layer loop (register block)

struct ServeArgs {
  const float* obs;      // (B, N, obs_dim) with strides sb, sn, 1
  long long sb, sn;
  int obs_dim;
  const float* W[MAX_LAYERS];  // (F, N, dims[l], dims[l+1])
  const float* b[MAX_LAYERS];  // (F, N, dims[l+1])
  int dims[MAX_LAYERS + 1];
  int n_layers;
  int n_agents, batch, n_members;
  const int* route;  // (B,) member of each request, or null (solo)
  uint32_t k0, k1;   // launch key words (sample mode)
  int sample;
  float alpha;
  int tile;  // rows per CTA, a multiple of RB
  int ld;    // shared-memory row stride in floats
  int* actions;  // (B, N)
  float* probs;  // (B, N, A)
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

// One threefry2x32 block: key (k0, k1), counter (x0, x1).
__device__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1,
                             uint32_t* o0, uint32_t* o1) {
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl32(x1, rot[g & 1][r]) ^ x0;
    }
    x0 += ks[(g + 1) % 3];
    x1 += ks[(g + 2) % 3] + (uint32_t)(g + 1);
  }
  *o0 = x0;
  *o1 = x1;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// out[r][j] = act(sum_k in[r][k] * W[k][j] + bias[j]) for the tile's rows.
// Threads split the columns; when a layer is narrower than the block,
// the spare threads take further groups of RB rows.
template <bool BF16>
__device__ void dense_layer(const float* in, float* out, const float* __restrict__ W,
                            const float* __restrict__ bias, int n_in, int n_out,
                            bool hidden, float alpha, int tile, int ld) {
  const int ncols = n_out < THREADS ? n_out : THREADS;
  const int groups = THREADS / ncols;
  const int g = threadIdx.x / ncols;
  if (g >= groups) return;
  for (int j = threadIdx.x % ncols; j < n_out; j += ncols) {
    const float bj = __ldg(bias + j);
    for (int r0 = g * RB; r0 < tile; r0 += groups * RB) {
      float acc[RB];
#pragma unroll
      for (int i = 0; i < RB; ++i) acc[i] = 0.0f;
      const float* row = in + r0 * ld;
#pragma unroll 4
      for (int k = 0; k < n_in; ++k) {
        float w = __ldg(W + (size_t)k * n_out + j);
        if (BF16) w = round_bf16(w);
#pragma unroll
        for (int i = 0; i < RB; ++i) acc[i] = fmaf(row[i * ld + k], w, acc[i]);
      }
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        float v = acc[i] + bj;
        if (hidden) {
          v = v >= 0.0f ? v : alpha * v;
          // the next layer's dot reads this value as a bf16 operand
          if (BF16) v = round_bf16(v);
        }
        out[(r0 + i) * ld + j] = v;
      }
    }
  }
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
serve_kernel(const ServeArgs a) {
  extern __shared__ float smem[];
  float* buf[2] = {smem, smem + a.tile * a.ld};
  const int n = blockIdx.y;
  const int row0 = blockIdx.x * a.tile;
  const int rows = min(a.tile, a.batch - row0);
  const int n_actions = a.dims[a.n_layers];
  const int w0 = a.dims[0];
  const int tid = threadIdx.x;
  const bool fleet = a.route != nullptr;

  // a request routed outside [0, F) gets action -1 and NaN probabilities
  if (fleet && tid < rows) {
    const int m = a.route[row0 + tid];
    if (m < 0 || m >= a.n_members) {
      const size_t o = (size_t)(row0 + tid) * a.n_agents + n;
      a.actions[o] = -1;
      for (int c = 0; c < n_actions; ++c) a.probs[o * n_actions + c] = __int_as_float(0x7fc00000);
    }
  }

  for (int f = 0; f < a.n_members; ++f) {
    if (fleet) {
      const bool mine = tid < rows && a.route[row0 + tid] == f;
      if (!__syncthreads_or(mine)) continue;
    }
    // observations, zero-padded to the first layer's width and to the
    // tile's height
    for (int idx = tid; idx < a.tile * w0; idx += THREADS) {
      const int r = idx / w0, k = idx % w0;
      float v = 0.0f;
      if (r < rows && k < a.obs_dim) v = a.obs[(row0 + r) * a.sb + n * a.sn + k];
      if (BF16) v = round_bf16(v);
      buf[0][r * a.ld + k] = v;
    }
    __syncthreads();
    int cur = 0;
    for (int l = 0; l < a.n_layers; ++l) {
      const int n_in = a.dims[l], n_out = a.dims[l + 1];
      const size_t cell = (size_t)f * a.n_agents + n;
      dense_layer<BF16>(buf[cur], buf[cur ^ 1], a.W[l] + cell * n_in * n_out,
                        a.b[l] + cell * n_out, n_in, n_out, l + 1 < a.n_layers,
                        a.alpha, a.tile, a.ld);
      __syncthreads();
      cur ^= 1;
    }
    // softmax and the action, one thread per request row
    if (tid < rows && (!fleet || a.route[row0 + tid] == f)) {
      const float* logit = buf[cur] + tid * a.ld;
      const int b = row0 + tid;
      const size_t o = (size_t)b * a.n_agents + n;
      float m = logit[0];
      for (int c = 1; c < n_actions; ++c) m = fmaxf(m, logit[c]);
      float s = 0.0f;
      for (int c = 0; c < n_actions; ++c) s += expf(logit[c] - m);
      uint32_t kn0 = 0, kn1 = 0;
      if (a.sample) {
        uint32_t kb0, kb1;
        threefry2x32(a.k0, a.k1, 0u, (uint32_t)b, &kb0, &kb1);
        threefry2x32(kb0, kb1, 0u, (uint32_t)n, &kn0, &kn1);
      }
      int best = 0;
      float best_v = 0.0f;
      for (int c = 0; c < n_actions; ++c) {
        const float p = expf(logit[c] - m) / s;
        a.probs[o * n_actions + c] = p;
        float v = p;
        if (a.sample) {
          uint32_t o0, o1;
          threefry2x32(kn0, kn1, 0u, (uint32_t)c, &o0, &o1);
          const uint32_t bits = o0 ^ o1;
          const float tiny = 1.17549435e-38f;
          const float fl = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
          const float u = fmaxf(tiny, fl * (1.0f - tiny) + tiny);
          v = -logf(-logf(u)) + logf(p);
        }
        if (c == 0 || v > best_v) {
          best = c;
          best_v = v;
        }
      }
      a.actions[o] = best;
    }
    __syncthreads();
  }
}

extern "C" int rcmarl_serve_launch(
    const float* obs, long long sb, long long sn, int obs_dim,
    const float* const* W, const float* const* bias, const int* dims,
    int n_layers, int n_agents, int batch, int n_members, const int* route,
    unsigned int k0, unsigned int k1, int sample, int bf16, float alpha,
    int tile, int* actions, float* probs, void* stream) {
  if (n_layers < 1 || n_layers > MAX_LAYERS || tile < RB || tile % RB != 0 ||
      tile > THREADS || batch < 1 || n_agents < 1 || n_members < 1)
    return (int)cudaErrorInvalidValue;
  ServeArgs a;
  a.obs = obs;
  a.sb = sb;
  a.sn = sn;
  a.obs_dim = obs_dim;
  int widest = 0;
  for (int l = 0; l <= n_layers; ++l) {
    a.dims[l] = dims[l];
    if (dims[l] > widest) widest = dims[l];
  }
  for (int l = 0; l < n_layers; ++l) {
    a.W[l] = W[l];
    a.b[l] = bias[l];
  }
  a.n_layers = n_layers;
  a.n_agents = n_agents;
  a.batch = batch;
  a.n_members = n_members;
  a.route = route;
  a.k0 = k0;
  a.k1 = k1;
  a.sample = sample;
  a.alpha = alpha;
  a.tile = tile;
  a.ld = widest + 1;  // odd stride: rows of one column fall in distinct banks
  a.actions = actions;
  a.probs = probs;
  const size_t smem = 2 * (size_t)tile * a.ld * sizeof(float);
  const dim3 grid((batch + tile - 1) / tile, n_agents);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (bf16) {
    err = cudaFuncSetAttribute(serve_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    serve_kernel<true><<<grid, THREADS, smem, s>>>(a);
  } else {
    err = cudaFuncSetAttribute(serve_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    serve_kernel<false><<<grid, THREADS, smem, s>>>(a);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* rcmarl_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
