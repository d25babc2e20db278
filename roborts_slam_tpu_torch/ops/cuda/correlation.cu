// Correlation scoring kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_correlation_kernel` of the JAX package
// (roborts_slam_tpu/ops/pallas/correlation.py, reached through
// `score_candidates_pallas`): for one search tier it computes
//
//   score[b,a,kx,ky] = (sum_s v(b,a,s,kx,ky)) / divisor[b]
//   v = 0                      if sample s is not a valid scan point
//     = default_prob           if the candidate cell lies outside the map
//     = probs[b, gy, gx]       otherwise
//   gx = floor(rx[b,a,s] + xs[b,kx] + 0.5),  gy = floor(ry[b,a,s] + ys[b,ky] + 0.5)
//
// What bounds it on this card: it is a data-dependent 2-D gather with
// A*S*N*N four-byte reads per map and as many adds. The reads of
// neighbouring candidates fall into the same or adjacent 32-byte sectors
// (candidate steps are 1-10 cells), so the traffic that reaches device
// memory is the set of distinct map sectors touched — a few hundred KB per
// tier out of a 36 MiB map that fits the 50 MB L2 — and the bound is the
// issue rate of the dependent loads, not bytes.
//
// Design: one block per (b, a). The block stages that angle's S rotated
// sample coordinates in shared memory once; each thread owns candidates
// (kx, ky) and walks the samples in index order, reading the f32 map through
// the read-only path. No TPU-shaped slab crop, lane roll or bf16 map copy is
// carried over: the kernel reads the map where it lies.
//
// Rounding: `gx` is formed by two separate round-to-nearest adds
// (__fadd_rn), exactly as the plain PyTorch version forms it, so nvcc cannot
// contract the adds with neighbouring arithmetic; the running sum is an
// __fadd_rn chain too (adds of loaded values have no multiply to fuse with,
// the intrinsic states the intent).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void correlation_scores_kernel(
    const float* __restrict__ probs,            // (B, H, W)
    const float* __restrict__ rx,               // (B, A, S)
    const float* __restrict__ ry,               // (B, A, S)
    const unsigned char* __restrict__ svalid,   // (B, S)
    const float* __restrict__ xs,               // (B, N)
    const float* __restrict__ ys,               // (B, N)
    const float* __restrict__ divisor,          // (B,)
    float* __restrict__ scores,                 // (B, A, N, N)
    int A, int S, int N, int H, int W, float default_prob)
{
    extern __shared__ float smem[];
    float* srx = smem;                // S
    float* sry = smem + S;            // S
    unsigned char* sval = reinterpret_cast<unsigned char*>(smem + 2 * S);  // S

    const int b = blockIdx.x / A;
    const int a = blockIdx.x % A;
    const size_t row = (static_cast<size_t>(b) * A + a) * S;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
        srx[s] = rx[row + s];
        sry[s] = ry[row + s];
        sval[s] = svalid[static_cast<size_t>(b) * S + s];
    }
    __syncthreads();

    const float* map = probs + static_cast<size_t>(b) * H * W;
    const float div = divisor[b];
    for (int c = threadIdx.x; c < N * N; c += blockDim.x) {
        const int kx = c / N;
        const int ky = c % N;
        const float cx = xs[static_cast<size_t>(b) * N + kx];
        const float cy = ys[static_cast<size_t>(b) * N + ky];
        float acc = 0.0f;
        for (int s = 0; s < S; ++s) {
            float v = 0.0f;
            if (sval[s]) {
                const float fx = floorf(__fadd_rn(__fadd_rn(srx[s], cx), 0.5f));
                const float fy = floorf(__fadd_rn(__fadd_rn(sry[s], cy), 0.5f));
                // compare as floats: the cast of a huge value is undefined
                if (fx >= 0.0f && fx < static_cast<float>(W) &&
                    fy >= 0.0f && fy < static_cast<float>(H)) {
                    v = __ldg(map + static_cast<size_t>(static_cast<int>(fy)) * W
                              + static_cast<int>(fx));
                } else {
                    v = default_prob;
                }
            }
            acc = __fadd_rn(acc, v);
        }
        scores[((static_cast<size_t>(b) * A + a) * N + kx) * N + ky] =
            __fdiv_rn(acc, div);
    }
}

}  // namespace

extern "C" int correlation_scores_launch(
    const float* probs, const float* rx, const float* ry,
    const unsigned char* svalid, const float* xs, const float* ys,
    const float* divisor, float* scores,
    int B, int A, int S, int N, int H, int W, float default_prob,
    void* stream)
{
    const size_t shmem = 2 * static_cast<size_t>(S) * sizeof(float) + S;
    correlation_scores_kernel<<<B * A, kThreads, shmem,
                                static_cast<cudaStream_t>(stream)>>>(
        probs, rx, ry, svalid, xs, ys, divisor, scores,
        A, S, N, H, W, default_prob);
    return static_cast<int>(cudaGetLastError());
}
