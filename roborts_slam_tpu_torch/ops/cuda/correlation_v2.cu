// Correlation scoring kernel, second version, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_correlation_kernel_v2` of the JAX package
// (roborts_slam_tpu/ops/pallas/correlation.py, reached through
// `accumulate_windows_v2` / `score_candidates_pallas_v2`, selected with
// ROBORTS_CORR_KERNEL=2). It computes the same function as
// `correlation_scores_kernel` (correlation.cu):
//
//   score[b,a,kx,ky] = (sum_s v(b,a,s,kx,ky)) / divisor[b]
//   v = 0                      if sample s is not a valid scan point
//     = default_prob           if the candidate cell lies outside the map
//     = probs[b, gy, gx]       otherwise
//   gx = floor(rx[b,a,s] + xs[b,kx] + 0.5),  gy = floor(ry[b,a,s] + ys[b,ky] + 0.5)
//
// What the TPU kernel adds over its first version is work shared between
// candidate windows (there: two windows through one convert, one sublane
// roll and one add). Its slab, lane alignment, sort and even-padding exist
// only for that machine and are not carried over. What is shared here: the
// cell index is separable — gx depends on (s, kx) only and gy on (s, ky)
// only — yet the first kernel forms both for each of the N*N candidates of
// every sample (four adds, two floors, four compares per load). This kernel
// forms them once per row and per column of the candidate window: for a tile
// of samples (all of a tier's samples at once where the tables fit the
// default 48 KB) the block fills two tables in shared memory, `col[s][kx]` (the
// map column, or -1 outside) and `rowoff[s][ky]` (gy*W, or -1 outside) —
// 2*N index computations per sample instead of 2*N*N — and each thread,
// owning candidates as in the first kernel, adds map[rowoff + col] per
// sample with two shared-memory reads and one compare.
//
// What bounds it on this card: as for the first kernel, the issue rate of
// dependent loads from a map that sits in L2, not bytes; one block per
// (b, a) leaves most SMs idle at B = 1.
//
// Rounding: the two adds are separate round-to-nearest adds (__fadd_rn) in
// the plain version's order, the floored coordinate is compared as a float
// before the cast, and the running sum is an __fadd_rn chain in sample
// order: the same cells and the same sum order as the first kernel, so the
// two agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void correlation_scores_v2_kernel(
    const float* __restrict__ probs,            // (B, H, W)
    const float* __restrict__ rx,               // (B, A, S)
    const float* __restrict__ ry,               // (B, A, S)
    const unsigned char* __restrict__ svalid,   // (B, S)
    const float* __restrict__ xs,               // (B, N)
    const float* __restrict__ ys,               // (B, N)
    const float* __restrict__ divisor,          // (B,)
    float* __restrict__ scores,                 // (B, A, N, N)
    int A, int S, int N, int H, int W, int tile, float default_prob)
{
    extern __shared__ int tables[];
    int* col = tables;                          // tile * N
    int* rowoff = tables + tile * N;            // tile * N
    unsigned char* sval =
        reinterpret_cast<unsigned char*>(tables + 2 * tile * N);   // tile

    const int b = blockIdx.x / A;
    const int a = blockIdx.x % A;
    const size_t row = (static_cast<size_t>(b) * A + a) * S;
    const float* map = probs + static_cast<size_t>(b) * H * W;
    const float* bxs = xs + static_cast<size_t>(b) * N;
    const float* bys = ys + static_cast<size_t>(b) * N;
    const float div = divisor[b];
    const float fW = static_cast<float>(W);
    const float fH = static_cast<float>(H);

    // a thread owns the candidates c0 + threadIdx.x; for N*N <= blockDim.x
    // (every shipped tier) this outer loop runs once
    for (int c0 = 0; c0 < N * N; c0 += blockDim.x) {
        const int c = c0 + threadIdx.x;
        const bool owner = c < N * N;
        const int kx = owner ? c / N : 0;
        const int ky = owner ? c % N : 0;
        float acc = 0.0f;
        for (int s0 = 0; s0 < S; s0 += tile) {
            const int ns = min(tile, S - s0);
            __syncthreads();        // the previous tile's tables are done with
            for (int i = threadIdx.x; i < ns * N; i += blockDim.x) {
                const int s = i / N;
                const int k = i % N;
                const float fx = floorf(__fadd_rn(__fadd_rn(rx[row + s0 + s], bxs[k]), 0.5f));
                const float fy = floorf(__fadd_rn(__fadd_rn(ry[row + s0 + s], bys[k]), 0.5f));
                // compare as floats: the cast of a huge value is undefined
                col[i] = (fx >= 0.0f && fx < fW) ? static_cast<int>(fx) : -1;
                rowoff[i] = (fy >= 0.0f && fy < fH) ? static_cast<int>(fy) * W : -1;
            }
            for (int s = threadIdx.x; s < ns; s += blockDim.x)
                sval[s] = svalid[static_cast<size_t>(b) * S + s0 + s];
            __syncthreads();
            if (owner) {
#pragma unroll 4
                for (int s = 0; s < ns; ++s) {
                    float v = 0.0f;
                    if (sval[s]) {
                        const int cx = col[s * N + kx];
                        const int ro = rowoff[s * N + ky];
                        v = ((cx | ro) >= 0) ? __ldg(map + ro + cx) : default_prob;
                    }
                    acc = __fadd_rn(acc, v);
                }
            }
        }
        if (owner)
            scores[((static_cast<size_t>(b) * A + a) * N + kx) * N + ky] =
                __fdiv_rn(acc, div);
    }
}

}  // namespace

// `tile` samples are staged per pass; the caller sizes it so that the
// tables (2 * tile * N ints + tile bytes) fit the default 48 KB of dynamic
// shared memory. H * W must be below 2^31 (row offsets are 32-bit).
extern "C" int correlation_scores_v2_launch(
    const float* probs, const float* rx, const float* ry,
    const unsigned char* svalid, const float* xs, const float* ys,
    const float* divisor, float* scores,
    int B, int A, int S, int N, int H, int W, int tile, float default_prob,
    void* stream)
{
    const size_t shmem = 2 * static_cast<size_t>(tile) * N * sizeof(int) + tile;
    correlation_scores_v2_kernel<<<B * A, kThreads, shmem,
                                   static_cast<cudaStream_t>(stream)>>>(
        probs, rx, ry, svalid, xs, ys, divisor, scores,
        A, S, N, H, W, tile, default_prob);
    return static_cast<int>(cudaGetLastError());
}
