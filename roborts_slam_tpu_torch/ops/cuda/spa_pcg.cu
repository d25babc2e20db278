// The preconditioned conjugate gradient of one Levenberg-Marquardt iteration
// of the SPA pose-graph solve, in one launch, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's `_pcg` (roborts_slam_tpu/
// backend/spa.py) is a `lax.while_loop` that XLA compiles. The port runs it
// as this kernel on the card; the masked PyTorch loop (`backend/spa.py::_pcg`)
// stays as its counterpart on the CPU and in the tests.
//
// It solves (H + lam * gauge) x = b, H = sum_e J_e^T I_e J_e, block-Jacobi
// preconditioned by the inverses `pinv` (N, 3, 3) of H's diagonal blocks,
// with the masked loop's arithmetic in fp32 (clamps 1e-20 on both
// denominators) and JAX's stopping test: at most `iters` steps, each taken
// while ||r|| > tol * max(||b||, 1e-12) before it. A step after the test
// fails is not computed. Where the LM carry's `done` is set the kernel
// writes x = 0 and 0 steps at once (the LM iteration discards both).
//
// What bounds it: not bytes, not operations. A step of a 2048-node graph
// with 4096 edges moves about 0.75 MB and computes about 0.5 MFLOP
// (0.2 us at 3.35 TB/s); the masked loop ran ~46 small launches a step and
// all 100 steps. What is left here is latency: four barriers of the
// cluster, two reductions and the dependent loads of a step.
//
// Design.
// - One cluster of C CTAs holds the whole graph: CTA r owns nodes
//   [r*node_span, (r+1)*node_span) and edges [r*edge_span, (r+1)*edge_span).
//   C, the threads and the nodes and edges per thread (NPT <= 2, EPT <= 4)
//   follow from the padded shape (spa_pcg.py::geometry): one CTA up to 1024
//   nodes and 2048 edges, a cluster of up to 8 (portable) up to 8192 nodes
//   and 16384 edges. No knob chooses it.
// - A thread keeps its nodes' r and z in registers; p sits in shared memory,
//   where the edges of every CTA read it (distributed shared memory), and
//   so do x and the preconditioner blocks, loaded once (x and the incidence
//   lists' bounds off the registers: 2 nodes and 4 edges a thread fill the
//   128 that 512 threads may have).
// - A thread keeps its edges in registers for the whole call: the endpoints'
//   addresses of p in the cluster, the non-constant Jacobian entries
//   (c, s and the two lever arms; J_b = [[c, s, 0], [-s, c, 0], [0, 0, 1]],
//   J_a = [[-c, -s, la0], [s, -c, la1], [0, 0, -1]], as
//   `edge_jacobians` builds them) and the information matrix. No edge byte
//   is read again after the first.
// - H p without atomics: each edge writes J_a^T I J p and J_b^T I J p to its
//   CTA's shared memory; each node adds its incident edges' terms in the
//   order of its incidence list (`spa_pcg.py::incidence`: the edges where
//   it is the source in edge order, then those where it is the target),
//   which is `index_add_`'s order on the CPU. Node 0 and padding nodes
//   (gauge 0) skip the sum: their row of H p is zeroed by the gauge anyway,
//   and node 0 holds every padding edge at (0, 0).
// - Dot products: a warp's butterfly, one slot a warp in shared memory, a
//   barrier of the cluster, then every warp adds all slots of the cluster in
//   one fixed order. Every thread holds the same bits, so the loop's test is
//   the same everywhere, and a solve repeats bit for bit.
//
// A step: edges (read p) | barrier | nodes: H p, p.Hp | barrier | alpha, x,
// r, z, r.z, r.r | barrier | beta, p | barrier.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// The launch's shape and scalars, filled by the wrapper (spa_pcg.py's
// _Geometry; outside the unnamed namespace, as a type of the C interface).
struct PcgGeometry {
    int nodes, edges;          // N, E (padded)
    int cluster;               // CTAs of the one cluster
    int threads;               // threads of a CTA
    int node_span, edge_span;  // nodes and edges a CTA owns
    int npt, ept;              // nodes and edges a thread owns (template)
    int iters;                 // most CG steps
    int smem_bytes;            // dynamic shared memory of a CTA
    float tol;                 // relative residual test
};

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
    // a butterfly: a + b == b + a, so every lane ends with the same bits
#pragma unroll
    for (int m = 16; m; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
    return v;
}

struct Cluster {
    cg::cluster_group group;
    int size;

    __device__ __forceinline__ void sync() {
        if (size == 1) __syncthreads();
        else group.sync();
    }
    // ``ptr`` in the shared memory of CTA ``rank``
    __device__ __forceinline__ float* at(float* ptr, int rank) {
        return size == 1 ? ptr : group.map_shared_rank(ptr, rank);
    }
    // the sum over the cluster of one slot a warp, in a fixed order
    __device__ __forceinline__ float sum(float* slots, int warps, int lane) {
        float v = 0.f;
        for (int i = lane; i < size * warps; i += 32) {
            const int r = i / warps;
            v += at(slots, r)[i - r * warps];
        }
        return warp_sum(v);
    }
};

template <int NPT, int EPT>
__global__ void __launch_bounds__(kMaxThreads, 1) spa_pcg_kernel(
    const float* __restrict__ ja, const float* __restrict__ jb,
    const float* __restrict__ info, const float* __restrict__ gauge,
    const float* __restrict__ pinv, const float* __restrict__ b,
    const float* __restrict__ lam_p, const bool* __restrict__ done_p,
    const long long* __restrict__ edge_ij, const int* __restrict__ ptr,
    const int* __restrict__ entries, float* __restrict__ x_out,
    int* __restrict__ steps_out, const PcgGeometry g)
{
    Cluster cl{cg::this_cluster(), g.cluster};
    const int rank = (int)cl.group.block_rank();
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int warps = blockDim.x >> 5;
    const int N = g.nodes, E = g.edges, ns = g.node_span, es = g.edge_span;

    extern __shared__ float smem[];
    float* p_s = smem;                      // ns * 3
    float* x_s = p_s + 3 * ns;              // ns * 3
    float* pinv_s = x_s + 3 * ns;           // ns * 9
    float* gout_s = pinv_s + 9 * ns;        // es * 6: J_a^T I J p | J_b^T I J p
    float* slot_a = gout_s + 6 * es;        // kMaxWarps each
    float* slot_b = slot_a + kMaxWarps;
    float* slot_c = slot_b + kMaxWarps;

    if (*done_p) {
#pragma unroll
        for (int k = 0; k < NPT; ++k) {
            const int loc = tid + k * blockDim.x, n = rank * ns + loc;
            if (loc < ns && n < N) {
                x_out[3 * n] = 0.f; x_out[3 * n + 1] = 0.f; x_out[3 * n + 2] = 0.f;
            }
        }
        if (rank == 0 && tid == 0) *steps_out = 0;
        return;
    }
    const float lam = *lam_p;

    // ---- the thread's nodes ----
    bool nv[NPT];
    float gk[NPT], r[NPT][3], z[NPT][3];
    float rz_part = 0.f, bb_part = 0.f;
#pragma unroll
    for (int k = 0; k < NPT; ++k) {
        const int loc = tid + k * blockDim.x, n = rank * ns + loc;
        nv[k] = loc < ns && n < N;
        gk[k] = 0.f;
#pragma unroll
        for (int i = 0; i < 3; ++i) r[k][i] = z[k][i] = 0.f;
        if (loc < ns) {
            float* pi = pinv_s + 9 * loc;
#pragma unroll
            for (int i = 0; i < 9; ++i) pi[i] = nv[k] ? pinv[9 * n + i] : 0.f;
            x_s[3 * loc] = x_s[3 * loc + 1] = x_s[3 * loc + 2] = 0.f;
        }
        if (!nv[k]) {
            if (loc < ns) p_s[3 * loc] = p_s[3 * loc + 1] = p_s[3 * loc + 2] = 0.f;
            continue;
        }
        gk[k] = gauge[n];
        const float* pi = pinv_s + 9 * loc;
#pragma unroll
        for (int i = 0; i < 3; ++i) r[k][i] = b[3 * n + i];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            z[k][i] = (pi[3 * i] * r[k][0] + pi[3 * i + 1] * r[k][1] + pi[3 * i + 2] * r[k][2])
                      * gk[k];
            p_s[3 * loc + i] = z[k][i];
        }
        rz_part += r[k][0] * z[k][0] + r[k][1] * z[k][1] + r[k][2] * z[k][2];
        bb_part += r[k][0] * r[k][0] + r[k][1] * r[k][1] + r[k][2] * r[k][2];
    }

    // ---- the thread's edges ----
    bool ev[EPT];
    const float* pa[EPT];
    const float* pb[EPT];
    float ec[EPT], es_[EPT], la0[EPT], la1[EPT], im[EPT][9];
#pragma unroll
    for (int k = 0; k < EPT; ++k) {
        const int loc = tid + k * blockDim.x, e = rank * es + loc;
        ev[k] = loc < es && e < E;
        pa[k] = pb[k] = p_s;
        ec[k] = es_[k] = la0[k] = la1[k] = 0.f;
#pragma unroll
        for (int i = 0; i < 9; ++i) im[k][i] = 0.f;
        if (!ev[k]) continue;
        const int a = (int)edge_ij[2 * e], c = (int)edge_ij[2 * e + 1];
        pa[k] = cl.at(p_s, a / ns) + 3 * (a % ns);
        pb[k] = cl.at(p_s, c / ns) + 3 * (c % ns);
        ec[k] = jb[9 * e];
        es_[k] = jb[9 * e + 1];
        la0[k] = ja[9 * e + 2];
        la1[k] = ja[9 * e + 5];
#pragma unroll
        for (int i = 0; i < 9; ++i) im[k][i] = info[9 * e + i];
    }

    // ---- r.z and b.b of the start, the cluster's p and pinv published ----
    rz_part = warp_sum(rz_part);
    bb_part = warp_sum(bb_part);
    if (lane == 0) { slot_a[warp] = rz_part; slot_b[warp] = bb_part; }
    cl.sync();
    float rz = cl.sum(slot_a, warps, lane);
    float rr = cl.sum(slot_b, warps, lane);
    const float thr = g.tol * fmaxf(sqrtf(rr), 1e-12f);

    int steps = 0;
    while (steps < g.iters && sqrtf(rr) > thr) {
        ++steps;
        // edges: J^T I J p of each edge, both sides
#pragma unroll
        for (int k = 0; k < EPT; ++k) {
            if (!ev[k]) continue;
            const float c = ec[k], s = es_[k];
            const float a0 = pa[k][0], a1 = pa[k][1], a2 = pa[k][2];
            const float b0 = pb[k][0], b1 = pb[k][1], b2 = pb[k][2];
            const float j0 = (-c * a0 - s * a1 + la0[k] * a2) + (c * b0 + s * b1);
            const float j1 = (s * a0 - c * a1 + la1[k] * a2) + (-s * b0 + c * b1);
            const float j2 = -a2 + b2;
            const float* I = im[k];
            const float i0 = I[0] * j0 + I[1] * j1 + I[2] * j2;
            const float i1 = I[3] * j0 + I[4] * j1 + I[5] * j2;
            const float i2 = I[6] * j0 + I[7] * j1 + I[8] * j2;
            float* o = gout_s + 6 * (tid + k * blockDim.x);
            o[0] = -c * i0 + s * i1;
            o[1] = -s * i0 - c * i1;
            o[2] = la0[k] * i0 + la1[k] * i1 - i2;
            o[3] = c * i0 - s * i1;
            o[4] = s * i0 + c * i1;
            o[5] = i2;
        }
        cl.sync();
        // nodes: (H + lam) p in incidence order, and p.Hp
        float h[NPT][3];
        float pap_part = 0.f;
#pragma unroll
        for (int k = 0; k < NPT; ++k) {
            h[k][0] = h[k][1] = h[k][2] = 0.f;
            if (!nv[k] || gk[k] == 0.f) continue;
            const int loc = tid + k * blockDim.x, n = rank * ns + loc;
            float s0 = 0.f, s1 = 0.f, s2 = 0.f;
            const int jend = ptr[n + 1];
            for (int j = ptr[n]; j < jend; ++j) {
                const int ent = entries[j];
                const int side = ent >= E;
                const int e = ent - side * E, er = e / es;
                const float* src = cl.at(gout_s, er) + 6 * (e - er * es) + 3 * side;
                s0 += src[0]; s1 += src[1]; s2 += src[2];
            }
            const float* p = p_s + 3 * loc;
            h[k][0] = s0 * gk[k] + lam * (p[0] * gk[k]);
            h[k][1] = s1 * gk[k] + lam * (p[1] * gk[k]);
            h[k][2] = s2 * gk[k] + lam * (p[2] * gk[k]);
            pap_part += p[0] * h[k][0] + p[1] * h[k][1] + p[2] * h[k][2];
        }
        pap_part = warp_sum(pap_part);
        if (lane == 0) slot_c[warp] = pap_part;
        cl.sync();
        const float alpha = rz / fmaxf(cl.sum(slot_c, warps, lane), 1e-20f);
        // x, r, z and the new r.z, r.r
        float rzn_part = 0.f, rr_part = 0.f;
#pragma unroll
        for (int k = 0; k < NPT; ++k) {
            if (!nv[k]) continue;
            const int loc = tid + k * blockDim.x;
            const float* p = p_s + 3 * loc;
            const float* pi = pinv_s + 9 * loc;
            float* x = x_s + 3 * loc;
#pragma unroll
            for (int i = 0; i < 3; ++i) {
                x[i] = x[i] + alpha * p[i];
                r[k][i] = r[k][i] - alpha * h[k][i];
            }
#pragma unroll
            for (int i = 0; i < 3; ++i)
                z[k][i] = (pi[3 * i] * r[k][0] + pi[3 * i + 1] * r[k][1]
                           + pi[3 * i + 2] * r[k][2]) * gk[k];
            rzn_part += r[k][0] * z[k][0] + r[k][1] * z[k][1] + r[k][2] * z[k][2];
            rr_part += r[k][0] * r[k][0] + r[k][1] * r[k][1] + r[k][2] * r[k][2];
        }
        rzn_part = warp_sum(rzn_part);
        rr_part = warp_sum(rr_part);
        if (lane == 0) { slot_a[warp] = rzn_part; slot_b[warp] = rr_part; }
        cl.sync();
        const float rz_new = cl.sum(slot_a, warps, lane);
        rr = cl.sum(slot_b, warps, lane);
        const float beta = rz_new / fmaxf(rz, 1e-20f);
        rz = rz_new;
#pragma unroll
        for (int k = 0; k < NPT; ++k) {
            if (!nv[k]) continue;
            float* p = p_s + 3 * (tid + k * blockDim.x);
#pragma unroll
            for (int i = 0; i < 3; ++i) p[i] = z[k][i] + beta * p[i];
        }
        cl.sync();
    }

#pragma unroll
    for (int k = 0; k < NPT; ++k) {
        if (!nv[k]) continue;
        const int loc = tid + k * blockDim.x, n = rank * ns + loc;
        x_out[3 * n] = x_s[3 * loc]; x_out[3 * n + 1] = x_s[3 * loc + 1];
        x_out[3 * n + 2] = x_s[3 * loc + 2];
    }
    if (rank == 0 && tid == 0) *steps_out = steps;
    cl.sync();      // no CTA leaves while another may still read its slots
}

using KernelFn = void (*)(const float*, const float*, const float*, const float*,
                          const float*, const float*, const float*, const bool*,
                          const long long*, const int*, const int*, float*, int*,
                          const PcgGeometry);

KernelFn pick(int npt, int ept) {
    if (npt == 1) {
        if (ept == 1) return spa_pcg_kernel<1, 1>;
        if (ept == 2) return spa_pcg_kernel<1, 2>;
        if (ept == 4) return spa_pcg_kernel<1, 4>;
    } else if (npt == 2) {
        if (ept == 1) return spa_pcg_kernel<2, 1>;
        if (ept == 2) return spa_pcg_kernel<2, 2>;
        if (ept == 4) return spa_pcg_kernel<2, 4>;
    }
    return nullptr;
}

cudaLaunchConfig_t config(const PcgGeometry& g, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(g.cluster, 1, 1);
    cfg.blockDim = dim3(g.threads, 1, 1);
    cfg.dynamicSmemBytes = g.smem_bytes;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = g.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

}  // namespace

// Once per geometry, before its first launch (and outside any capture):
// allows the kernel as much dynamic shared memory as a block of the current
// device may opt in to (so that no geometry lowers another's allowance) and
// writes how many clusters of this geometry the card holds at once (0: it
// cannot run).
extern "C" int spa_pcg_prepare(const PcgGeometry* geometry, int* max_clusters)
{
    const PcgGeometry g = *geometry;
    KernelFn kernel = pick(g.npt, g.ept);
    if (kernel == nullptr || g.threads > kMaxThreads || g.threads % 32 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    int device = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = config(g, nullptr, attr);
    err = cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
    return static_cast<int>(err);
}

extern "C" int spa_pcg_launch(
    const float* ja, const float* jb, const float* info, const float* gauge,
    const float* pinv, const float* b, const float* lam, const bool* done,
    const long long* edge_ij, const int* ptr, const int* entries,
    float* x_out, int* steps_out, const PcgGeometry* geometry, void* stream_)
{
    const PcgGeometry g = *geometry;
    KernelFn kernel = pick(g.npt, g.ept);
    if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = config(g, static_cast<cudaStream_t>(stream_), attr);
    cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, ja, jb, info, gauge, pinv, b, lam,
                                         done, edge_ij, ptr, entries, x_out, steps_out, g);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
