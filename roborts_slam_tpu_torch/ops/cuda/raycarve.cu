// Ray carving and ray checking kernels for Hopper (sm_90a).
//
// Replace the Pallas kernels `_carve_kernel` and `_raycheck_kernel` of the
// JAX package (roborts_slam_tpu/ops/pallas/raycarve.py, reached through
// `scan_mark_image_pallas` and `_bad_rays_pallas`). Both walk rays with the
// exact integer DDA of the plain versions:
//
//   n = max(|dx|, |dy|, 1),  cell(t) = floor(start + delta*t/n + 1/2)
//           = floor_div(2n*start + 2*delta*t + n, 2n),   t = 0..n
//
// (floor division: the numerator is negative for cells left of / below the
// map origin, and C++ `/` truncates toward zero).
//
// ray_mark_image: per-scan mark image, 1 on each ray's free prefix
// t in [0, n-1], 2 at the endpoint t = n; occupied beats free. Bounded by
// bytes: the (H, W) int32 image is written once (zeroed by the wrapper) and
// the ray cells touch a small part of it; the work per scan is
// sum_p (n_p + 1) cell visits. Design: one warp per beam, lanes stride over
// t, out-of-map cells are dropped, and each visit is one
// atomicMax(mark + cell, t == n ? 2 : 1): max commutes, so the result does
// not depend on block or lane order. The Pallas kernel's closed-form band
// predicate and carve window existed to fill (8,128) vector tiles; here the
// whole map is written directly.
//
// bad_ray_count: number of rays that visit, for t in [0, n], an occupied
// cell (passes >= min_passthrough and hits/passes >= occu_threshold) whose
// squared cell distance to the endpoint is >= thr_d2. Bounded by the
// dependent loads of two f32 planes along each ray (<= 100 rays per pose).
// Design: one warp per ray, lanes stride over t in chunks of 32 with a warp
// vote after each chunk (early out), lane 0 adds 1 to the pose's integer
// count (integer adds commute: deterministic). It reads the count planes
// where they lie; no occupancy bitmap or window is built. The probability
// is an IEEE divide (__fdiv_rn), as in the plain version.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ long long floor_div(long long a, long long b) {
    // b > 0
    long long q = a / b;
    if ((a % b != 0) && (a < 0)) --q;
    return q;
}

__device__ __forceinline__ int iabs(int v) { return v < 0 ? -v : v; }

__global__ void ray_mark_image_kernel(
    const int* __restrict__ start,               // (2,) [x, y]
    const int* __restrict__ end,                 // (P, 2)
    const unsigned char* __restrict__ beam_mask, // (P,)
    int P, int H, int W,
    int* __restrict__ mark)                      // (H, W), zeroed
{
    const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
    const int lane = threadIdx.x % 32;
    if (warp >= P || !beam_mask[warp]) return;
    const int sx = start[0], sy = start[1];
    const int dx = end[2 * warp] - sx;
    const int dy = end[2 * warp + 1] - sy;
    int n = max(iabs(dx), iabs(dy));
    if (n < 1) n = 1;
    const long long n2 = 2LL * n;
    for (int t = lane; t <= n; t += 32) {
        const long long cx = floor_div(n2 * sx + 2LL * dx * t + n, n2);
        const long long cy = floor_div(n2 * sy + 2LL * dy * t + n, n2);
        if (cx < 0 || cx >= W || cy < 0 || cy >= H) continue;
        atomicMax(mark + cy * W + cx, t == n ? 2 : 1);
    }
}

__global__ void bad_ray_count_kernel(
    const int* __restrict__ start,               // (B, 2)
    const int* __restrict__ end,                 // (B, S, 2)
    const unsigned char* __restrict__ ray_ok,    // (B, S)
    const float* __restrict__ hits,              // (H, W)
    const float* __restrict__ passes,            // (H, W)
    int B, int S, int H, int W,
    float min_passthrough, float occu_threshold, int thr_d2,
    int* __restrict__ out)                       // (B,), zeroed
{
    const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
    const int lane = threadIdx.x % 32;
    if (warp >= B * S || !ray_ok[warp]) return;   // uniform per warp
    const int b = warp / S;
    const int sx = start[2 * b], sy = start[2 * b + 1];
    const int ex = end[2 * warp], ey = end[2 * warp + 1];
    const int dx = ex - sx, dy = ey - sy;
    int n = max(iabs(dx), iabs(dy));
    if (n < 1) n = 1;
    const long long n2 = 2LL * n;
    for (int t0 = 0; t0 <= n; t0 += 32) {
        const int t = t0 + lane;
        bool bad = false;
        if (t <= n) {
            const long long cx = floor_div(n2 * sx + 2LL * dx * t + n, n2);
            const long long cy = floor_div(n2 * sy + 2LL * dy * t + n, n2);
            // occupancy is read at the cell clamped into the map, the
            // distance uses the unclamped cell (as the plain version)
            const long long rx = min(max(cx, 0LL), (long long)W - 1);
            const long long ry = min(max(cy, 0LL), (long long)H - 1);
            const float p = passes[ry * W + rx];
            const float h = hits[ry * W + rx];
            const float prob = p > 0.0f ? __fdiv_rn(h, fmaxf(p, 1e-9f)) : 0.5f;
            const long long ddx = cx - ex, ddy = cy - ey;
            const long long d2 = ddx * ddx + ddy * ddy;
            bad = (p >= min_passthrough) && (prob >= occu_threshold) &&
                  (d2 >= (long long)thr_d2);
        }
        if (__any_sync(0xffffffffu, bad)) {
            if (lane == 0) atomicAdd(out + b, 1);
            return;
        }
    }
}

}  // namespace

extern "C" int ray_mark_image_launch(
    const int* start, const int* end, const unsigned char* beam_mask,
    int P, int H, int W, int* mark, void* stream)
{
    const int threads = 32 * kWarpsPerBlock;
    const int blocks = (P + kWarpsPerBlock - 1) / kWarpsPerBlock;
    ray_mark_image_kernel<<<blocks, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        start, end, beam_mask, P, H, W, mark);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int bad_ray_count_launch(
    const int* start, const int* end, const unsigned char* ray_ok,
    const float* hits, const float* passes,
    int B, int S, int H, int W,
    float min_passthrough, float occu_threshold, int thr_d2,
    int* out, void* stream)
{
    const int threads = 32 * kWarpsPerBlock;
    const int blocks = (B * S + kWarpsPerBlock - 1) / kWarpsPerBlock;
    bad_ray_count_kernel<<<blocks, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        start, end, ray_ok, hits, passes, B, S, H, W,
        min_passthrough, occu_threshold, thr_d2, out);
    return static_cast<int>(cudaGetLastError());
}
