// Native batched matmul — the framework's C++ tier.
//
// Counterpart of the reference's only native-code artifact,
// examples/matmul_batch.cu (a naive one-thread-per-output-element CUDA
// batched matmul with a host malloc/copy/launch/verify round trip;
// reference matmul_batch.cu:7-153). The model's device matmuls are XLA's
// library GEMMs, so this C++ tier shows host-side compute wired into XLA
// as a custom-call (FFI) target — a cache-blocked fp32 batched matmul that
// JAX can invoke on the CPU platform, plus a standalone educational main()
// mirroring the reference example's alloc/fill/run/verify round trip.
//
// Build: `make -C native` -> libmatmul_batch.so (ctypes + XLA FFI) and
//        `matmul_batch` (standalone demo binary).

#include <algorithm>
#include <cstdint>
#include <cstring>

// ---------------------------------------------------------------------------
// Core kernel: C[b] = A[b] @ B(, [b])   A: (Bt, M, K)  B: (K, N) or (Bt, K, N)
//
// Cache-blocked i-k-j loop order: the innermost j-loop streams one row of C
// against one row of B, which vectorizes (gcc auto-vectorizes the FMA loop)
// and keeps B tiles hot in L1/L2 — the CPU analogue of a GPU GEMM's
// shared-memory tiling.
// ---------------------------------------------------------------------------

namespace {

constexpr int kBlockI = 64;
constexpr int kBlockK = 256;

void matmul_2d(const float* a, const float* b, float* c,
               int64_t m, int64_t k, int64_t n) {
  std::memset(c, 0, sizeof(float) * m * n);
  for (int64_t i0 = 0; i0 < m; i0 += kBlockI) {
    const int64_t i1 = std::min<int64_t>(i0 + kBlockI, m);
    for (int64_t k0 = 0; k0 < k; k0 += kBlockK) {
      const int64_t k1 = std::min<int64_t>(k0 + kBlockK, k);
      for (int64_t i = i0; i < i1; ++i) {
        float* ci = c + i * n;
        for (int64_t kk = k0; kk < k1; ++kk) {
          const float aik = a[i * k + kk];
          const float* bk = b + kk * n;
          for (int64_t j = 0; j < n; ++j) ci[j] += aik * bk[j];
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// ctypes entry point. b_batched: 0 = shared weight (K,N), 1 = per-batch
// (Bt,K,N) — the reference's matmul vs matmul3 distinction.
void vit_tpu_matmul_batch(const float* a, const float* b, float* c,
                          int64_t batch, int64_t m, int64_t k, int64_t n,
                          int b_batched) {
  for (int64_t bi = 0; bi < batch; ++bi) {
    matmul_2d(a + bi * m * k, b_batched ? b + bi * k * n : b,
              c + bi * m * n, m, k, n);
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// XLA FFI custom-call target (CPU platform): lets jax.ffi.ffi_call dispatch
// the native kernel from inside a jitted program.
// ---------------------------------------------------------------------------
#ifdef VIT_WITH_XLA_FFI
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

static ffi::Error MatmulBatchImpl(ffi::Buffer<ffi::F32> a,
                                  ffi::Buffer<ffi::F32> b,
                                  ffi::ResultBuffer<ffi::F32> c) {
  auto ad = a.dimensions();  // (Bt, M, K)
  auto bd = b.dimensions();  // (K, N) or (Bt, K, N)
  if (ad.size() != 3 || (bd.size() != 2 && bd.size() != 3)) {
    return ffi::Error::InvalidArgument("expected a:(B,M,K), b:(K,N)|(B,K,N)");
  }
  const int b_batched = bd.size() == 3;
  const int64_t batch = ad[0], m = ad[1], k = ad[2];
  const int64_t n = bd[b_batched ? 2 : 1];
  if (bd[b_batched ? 1 : 0] != k || (b_batched && bd[0] != batch)) {
    return ffi::Error::InvalidArgument("contraction/batch dim mismatch");
  }
  vit_tpu_matmul_batch(a.typed_data(), b.typed_data(), c->typed_data(),
                       batch, m, k, n, b_batched);
  return ffi::Error::Success();
}

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    MatmulBatch, MatmulBatchImpl,
    ffi::Ffi::Bind()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Ret<ffi::Buffer<ffi::F32>>());
#endif  // VIT_WITH_XLA_FFI

// ---------------------------------------------------------------------------
// Standalone demo: the reference example's round trip (alloc -> fill ->
// run -> verify vs naive loop -> report), reference matmul_batch.cu:7-153.
// ---------------------------------------------------------------------------
#ifdef VIT_MATMUL_MAIN
#include <chrono>
#include <cmath>
#include <cstdio>
#include <random>
#include <vector>

int main() {
  const int64_t batch = 4, m = 197, k = 768, n = 768;
  std::vector<float> a(batch * m * k), b(k * n), c(batch * m * n);
  std::mt19937 gen(0);
  std::normal_distribution<float> dist(0.f, 0.1f);
  for (auto& x : a) x = dist(gen);
  for (auto& x : b) x = dist(gen);

  const auto t0 = std::chrono::steady_clock::now();
  vit_tpu_matmul_batch(a.data(), b.data(), c.data(), batch, m, k, n, 0);
  const auto t1 = std::chrono::steady_clock::now();

  // Naive reference (the role the CUDA example's CPU check plays).
  double max_diff = 0.0;
  for (int64_t bi = 0; bi < batch; ++bi) {
    for (int64_t i = 0; i < m; i += 37) {        // sampled rows: keep it quick
      for (int64_t j = 0; j < n; j += 41) {
        double acc = 0.0;
        for (int64_t kk = 0; kk < k; ++kk)
          acc += a[(bi * m + i) * k + kk] * b[kk * n + j];
        max_diff = std::max(max_diff,
                            std::abs(acc - c[(bi * m + i) * n + j]));
      }
    }
  }
  const double ms =
      std::chrono::duration<double, std::milli>(t1 - t0).count();
  const double gflops = 2.0 * batch * m * k * n / 1e9;
  std::printf("matmul_batch (B=%lld M=%lld K=%lld N=%lld): %.2f ms, "
              "%.1f GFLOP/s, max|diff|=%.2e -> %s\n",
              (long long)batch, (long long)m, (long long)k, (long long)n, ms,
              gflops / (ms / 1e3), max_diff,
              max_diff < 1e-3 ? "PASSED" : "FAILED");
  return max_diff < 1e-3 ? 0 : 1;
}
#endif  // VIT_MATMUL_MAIN
