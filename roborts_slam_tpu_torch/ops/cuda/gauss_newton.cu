// The Gauss-Newton scan-to-map match (the optimize matcher), every pass of
// it in one launch, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's `optimize_scan_match`
// (roborts_slam_tpu/ops/gauss_newton.py, BasedOptimizeScanMatch,
// optimize_scan_matcher.h:60-237) is a `lax.while_loop` that XLA compiles to
// a few fusions. The port runs it as this kernel on the card; the plain
// PyTorch loop (`ops/gauss_newton.py::optimize_passes_plain`) stays as its
// counterpart on the CPU and in the tests.
//
// A pass at pose (x, y, th) in map cells (UpdateCost, :154-221): each valid
// point of the scan, scaled to cells and rotated, reads the map bilinearly
// (strict in-map comparisons on the float coordinates, the int cast before
// the clamp to the map, the response clamped to [0, 1]); its residual
// 1 - response and analytic Jacobian add to H = J^T J (six distinct
// entries), J^T e, the cost e.e and the in-map count (which starts at 1).
// Then one thread solves (H + 1e-9 I) d = -J^T e as `solve3` does it
// (partial pivoting on the first largest pivot, a zero pivot divided by),
// and decides as the plain loop does (:86-124): a NaN step stops with the
// cost K_MAX_COST; after the first pass a cost that fell by less than
// `cost_decrease` or lies under `cost_min` stops; a pass that does not stop
// moves the pose by the step clamped to +-max_d cells and +-max_angle. Each
// map of the batch stops on its own test: what a batched `while_loop` gives.
// Every product, sum and quotient of a point and of the solve is one f32
// operation in the plain version's order (no contraction into FMAs), so
// only the order of the sums over points differs from it.
//
// What bounds it: latency. One pass over 1152 points reads about 27 KB
// (four cells and a point each); the pass's reduction over the block and the
// solve on one thread, ten passes at most, are what a launch takes.
//
// Design. One CTA per map of the batch (the front end's one map, or each
// chain map of a back-end batch); the scan is shared. Thread t takes the
// points t, t + kThreads, ... A pass's sums: a warp's butterfly, one slot a
// warp in shared memory, then warp 0 adds the slots in a fixed order, so a
// launch repeats bit for bit. Lane 0 of warp 0 solves and writes the pose
// and the stop flag to shared memory, which every thread reads after a
// barrier.

#include <cuda_runtime.h>
#include <stdint.h>

// The launch's shape and scalars, filled by the wrapper
// (gauss_newton.py's _Params).
struct GnParams {
    int batch;            // maps, one CTA each
    int points;           // point slots of the scan
    int height, width;    // map cells
    long long map_stride; // floats between two maps (0: one map for all)
    int iters;            // most passes (iterate_max_times)
    float inv_res;        // cells per metre
    float cost_decrease;  // cost_decrease_threshold
    float cost_min;       // cost_min_threshold
    float max_d;          // max_update_distance in cells
    float max_angle;      // max_update_angle
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// H00 H01 H02 H11 H12 H22 | J^T e (3) | e.e | in-map count
constexpr int kSums = 11;
constexpr float kCostPointSize = 1000.f;   // optimize_scan_matcher.h:234
constexpr float kMaxCost = 1000.f;         // optimize_scan_matcher.h:235

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

__device__ __forceinline__ float warp_sum(float v) {
    // a butterfly: a + b == b + a, so every lane ends with the same bits
#pragma unroll
    for (int m = 16; m; m >>= 1) v = add(v, __shfl_xor_sync(0xffffffffu, v, m));
    return v;
}

// map[clamp(int(yi)) * W + clamp(int(xi))]: the cast first (toward zero,
// saturating), the clamp to the map after, as the plain version does
__device__ __forceinline__ float cell(const float* __restrict__ map, float xi, float yi,
                                      int H, int W) {
    const int xc = min(max(__float2int_rz(xi), 0), W - 1);
    const int yc = min(max(__float2int_rz(yi), 0), H - 1);
    return __ldg(map + (size_t)yc * W + xc);
}

// x of (H + 1e-9 I) x = b, H given by its six distinct entries: `solve3`'s
// elimination with partial pivoting (torch.argmax's first largest, a NaN
// counting as largest) and back substitution, operation for operation
__device__ void solve3(const float* s, float* x) {
    const float e = 1e-9f;
    float M[3][4] = {{add(s[0], e), s[1], s[2], -s[6]},
                     {s[1], add(s[3], e), s[4], -s[7]},
                     {s[2], s[4], add(s[5], e), -s[8]}};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        int p = k;
        float best = fabsf(M[k][k]);
#pragma unroll
        for (int r = k + 1; r < 3; ++r) {
            const float v = fabsf(M[r][k]);
            if (!isnan(best) && (isnan(v) || v > best)) { best = v; p = r; }
        }
        // the swap with rows named at compile time: M stays in registers
#pragma unroll
        for (int r = k + 1; r < 3; ++r) {
            if (p == r) {
#pragma unroll
                for (int c = 0; c < 4; ++c) { const float t = M[k][c]; M[k][c] = M[r][c]; M[r][c] = t; }
            }
        }
#pragma unroll
        for (int r = k + 1; r < 3; ++r) {
            const float f = dvd(M[r][k], M[k][k]);
#pragma unroll
            for (int c = 0; c < 4; ++c) M[r][c] = sub(M[r][c], mul(f, M[k][c]));
        }
    }
    x[2] = dvd(M[2][3], M[2][2]);
    x[1] = dvd(sub(M[1][3], mul(M[1][2], x[2])), M[1][1]);
    x[0] = dvd(sub(sub(M[0][3], mul(M[0][1], x[1])), mul(M[0][2], x[2])), M[0][0]);
}

__global__ void __launch_bounds__(kThreads) gauss_newton_match_kernel(
    const float* __restrict__ probs, const float* __restrict__ points,
    const bool* __restrict__ mask, const float* __restrict__ pose0,
    float* __restrict__ pose_out, float* __restrict__ cost_out,
    int* __restrict__ passes_out, const GnParams g)
{
    __shared__ float slots[kWarps][kSums];
    __shared__ float shared_pose[3];
    __shared__ int shared_stop;

    const int b = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const float* __restrict__ map = probs + b * g.map_stride;
    const int H = g.height, W = g.width;
    const float Hf = (float)H, Wf = (float)W;

    float px = pose0[3 * b], py = pose0[3 * b + 1], pt = pose0[3 * b + 2];
    float cost = 0.f;          // the cost carried between passes (lane 0 of warp 0)
    int passes = 0;
    for (int it = 0; it < g.iters; ++it) {
        const float c = cosf(pt), s = sinf(pt);
        float acc[kSums];
#pragma unroll
        for (int k = 0; k < kSums; ++k) acc[k] = 0.f;
        for (int i = tid; i < g.points; i += kThreads) {
            if (!mask[i]) continue;
            const float lx = mul(__ldg(points + 2 * i), g.inv_res);
            const float ly = mul(__ldg(points + 2 * i + 1), g.inv_res);
            const float mx = add(sub(mul(c, lx), mul(s, ly)), px);
            const float my = add(add(mul(s, lx), mul(c, ly)), py);
            if (!(mx > 0.f && mx < Wf && my > 0.f && my < Hf)) continue;
            const float x0 = floorf(mx), y0 = floorf(my);
            const float x1 = add(x0, 1.f), y1 = add(y0, 1.f);
            const float p00 = cell(map, x0, y0, H, W), p01 = cell(map, x0, y1, H, W);
            const float p10 = cell(map, x1, y0, H, W), p11 = cell(map, x1, y1, H, W);
            const float fx0 = sub(mx, x0), fx1 = sub(x1, mx);
            const float fy0 = sub(my, y0), fy1 = sub(y1, my);
            float resp = add(mul(fy0, add(mul(p11, fx0), mul(p01, fx1))),
                             mul(fy1, add(mul(p10, fx0), mul(p00, fx1))));
            resp = fminf(fmaxf(resp, 0.f), 1.f);
            const float err = sub(1.f, resp);
            const float dmx = add(mul(fy0, sub(p11, p01)), mul(fy1, sub(p10, p00)));
            const float dmy = add(mul(fx0, sub(p11, p10)), mul(fx1, sub(p01, p00)));
            const float dsx = sub(mul(-s, lx), mul(c, ly));
            const float dsy = sub(mul(c, lx), mul(s, ly));
            const float j0 = -dmx, j1 = -dmy, j2 = -add(mul(dmx, dsx), mul(dmy, dsy));
            acc[0] = add(acc[0], mul(j0, j0));
            acc[1] = add(acc[1], mul(j0, j1));
            acc[2] = add(acc[2], mul(j0, j2));
            acc[3] = add(acc[3], mul(j1, j1));
            acc[4] = add(acc[4], mul(j1, j2));
            acc[5] = add(acc[5], mul(j2, j2));
            acc[6] = add(acc[6], mul(j0, err));
            acc[7] = add(acc[7], mul(j1, err));
            acc[8] = add(acc[8], mul(j2, err));
            acc[9] = add(acc[9], mul(err, err));
            acc[10] = add(acc[10], 1.f);
        }
#pragma unroll
        for (int k = 0; k < kSums; ++k) {
            const float v = warp_sum(acc[k]);
            if (lane == 0) slots[warp][k] = v;
        }
        __syncthreads();
        if (warp == 0) {
            float tot[kSums];
#pragma unroll
            for (int k = 0; k < kSums; ++k)
                tot[k] = warp_sum(lane < kWarps ? slots[lane][k] : 0.f);
            if (lane == 0) {
                const float valid = add(tot[10], 1.f);       // the count starts at 1
                const float new_cost = mul(tot[9], dvd(kCostPointSize, valid));
                float d[3];
                solve3(tot, d);
                const bool nan = isnan(d[0]) || isnan(d[1]) || isnan(d[2]);
                bool stop = nan;
                if (it > 0)       // the first pass has no earlier cost to compare with
                    stop = stop || sub(cost, new_cost) < g.cost_decrease
                           || new_cost < g.cost_min;
                if (!stop) {
                    px = add(px, fmaxf(fminf(d[0], g.max_d), -g.max_d));
                    py = add(py, fmaxf(fminf(d[1], g.max_d), -g.max_d));
                    pt = add(pt, fmaxf(fminf(d[2], g.max_angle), -g.max_angle));
                }
                cost = nan ? kMaxCost : new_cost;
                shared_pose[0] = px; shared_pose[1] = py; shared_pose[2] = pt;
                shared_stop = stop;
            }
        }
        __syncthreads();
        px = shared_pose[0]; py = shared_pose[1]; pt = shared_pose[2];
        passes = it + 1;
        if (shared_stop) break;
    }
    if (tid == 0) {
        pose_out[3 * b] = px; pose_out[3 * b + 1] = py; pose_out[3 * b + 2] = pt;
        cost_out[b] = cost;
        passes_out[b] = passes;
    }
}

}  // namespace

extern "C" int gauss_newton_threads() { return kThreads; }

extern "C" int gauss_newton_launch(
    const float* probs, const float* points, const bool* mask, const float* pose0,
    float* pose_out, float* cost_out, int* passes_out, const GnParams* params,
    void* stream_)
{
    const GnParams g = *params;
    if (g.batch < 1 || g.points < 1 || g.height < 1 || g.width < 1 || g.iters < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    gauss_newton_match_kernel<<<g.batch, kThreads, 0, static_cast<cudaStream_t>(stream_)>>>(
        probs, points, mask, pose0, pose_out, cost_out, passes_out, g);
    return static_cast<int>(cudaGetLastError());
}
