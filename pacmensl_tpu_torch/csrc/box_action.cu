// Fused action of the truncated CME generator on a dense state box, with
// the sink derivatives, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel PallasBoxKernel
// (pacmensl_tpu/ops/pallas_box.py, _compute at :437-570, single block at
// :583-602, grid-tiled at :603-640).  For every flat C-order box index x:
//
//   ap_r(x)  = mask(x) ? a_r(x) * p(x) : 0
//   dp(x)    = sum_r c_r [ (mask(x) && srcok_r(x) ? ap_r(x - s_r) : 0) - ap_r(x) ]
//   sink_c   = sum_r c_r sum_x [bit c of viol_r(x)] * ap_r(x)
//
// srcok_r is the per-axis one-sided test that the source x - s_r lies in
// the box (pallas_box.py:525-539), on coordinates decoded from the flat
// index by integer div/mod.  A transition counts in every constraint it
// violates (reference sink semantics, FspMatrixConstrained.cpp:173-195).
//
// Inputs the TPU kernel recomputes in registers are read here instead:
// the propensity fields a[R, n] (evaluated once per box capacity by the
// caller's torch propensity, the reference's materialize=True variant) and
// the bit-packed violation masks viol[R, n] (bit c = f_c(x + s_r) > b_c,
// evaluated once per expansion epoch).  Recomputing propensities in
// registers, as the TPU kernel does, is the first performance step.
//
// What bounds it on this card: memory traffic.  Per element it reads p,
// the mask, R propensity values, R violation words and up to R shifted
// (p, a, mask) sources (mostly L2 hits), and writes dp: about
// 8 + 1 + 12R bytes of compulsory traffic.  The design keeps one thread
// per flat index in a grid-stride loop over a fixed grid (so every launch
// makes the same reduction tree), selects rather than multiplies by the
// mask (an inf or NaN propensity at an invalid position never reaches a
// sum), and writes per-block sink partials that a second one-block kernel
// sums in a fixed order: no float atomics, so the sinks are bitwise equal
// from run to run.  It is built with -fmad=false: each product and sum is
// rounded as in the plain PyTorch version, so dp matches it bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#define BOX_MAX_R 32
#define BOX_MAX_S 8
#define BOX_MAX_NC 32
#define BOX_THREADS 256

// Layout mirrored by the ctypes.Structure in ops/box_kernel.py.
struct BoxParams {
    double c[BOX_MAX_R];               // time coefficients c_r(t)
    long long kflat[BOX_MAX_R];        // flat source offset sum_d s_rd * stride_d
    long long shape[BOX_MAX_S];        // box extents
    int stoich[BOX_MAX_R][BOX_MAX_S];  // s_rd
    long long n;                       // prod(shape)
    int R;
    int S;
    int nc;
};

template <int NCM>
__global__ void __launch_bounds__(BOX_THREADS)
box_action_kernel(const BoxParams prm,
                  const double* __restrict__ p,
                  const uint8_t* __restrict__ mask,
                  const double* __restrict__ a,
                  const int32_t* __restrict__ viol,
                  double* __restrict__ dp,
                  double* __restrict__ sink_part)
{
    double sk[NCM];
#pragma unroll
    for (int c = 0; c < NCM; ++c) sk[c] = 0.0;

    const long long n = prm.n;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         idx < n; idx += stride) {
        double acc = 0.0;
        if (mask[idx]) {
            long long crd[BOX_MAX_S];
            long long rem = idx;
#pragma unroll
            for (int d = BOX_MAX_S - 1; d >= 0; --d) {
                if (d < prm.S) {
                    const long long e = prm.shape[d];
                    const long long q = rem / e;
                    crd[d] = rem - q * e;
                    rem = q;
                } else {
                    crd[d] = 0;
                }
            }
            const double pv = p[idx];
            for (int r = 0; r < prm.R; ++r) {
                const double cr = prm.c[r];
                const long long off = (long long)r * n;
                const double ap = a[off + idx] * pv;
                bool ok = true;
#pragma unroll
                for (int d = 0; d < BOX_MAX_S; ++d) {
                    if (d < prm.S) {
                        const int s = prm.stoich[r][d];
                        if (s > 0) ok = ok && (crd[d] - s >= 0);
                        else if (s < 0) ok = ok && (crd[d] - s < prm.shape[d]);
                    }
                }
                double in = 0.0;
                if (ok) {
                    const long long src = idx - prm.kflat[r];
                    if (mask[src]) in = a[off + src] * p[src];
                }
                acc += cr * (in - ap);
                const uint32_t bits = (uint32_t)viol[off + idx];
                if (bits) {
#pragma unroll
                    for (int c = 0; c < NCM; ++c)
                        if ((bits >> c) & 1u) sk[c] += cr * ap;
                }
            }
        }
        dp[idx] = acc;
    }

    // Block reduction of the sink partials: warp shuffles, then the warps'
    // sums in warp order.
    __shared__ double red[NCM][BOX_THREADS / 32];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int c = 0; c < NCM; ++c) {
        if (c < prm.nc) {
            double v = sk[c];
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
                v += __shfl_down_sync(0xffffffffu, v, o);
            if (lane == 0) red[c][warp] = v;
        }
    }
    __syncthreads();
    if (threadIdx.x < prm.nc) {
        double s = 0.0;
        for (int w = 0; w < BOX_THREADS / 32; ++w) s += red[threadIdx.x][w];
        sink_part[(long long)blockIdx.x * prm.nc + threadIdx.x] = s;
    }
}

// One block: sinks[c] = sum_b sink_part[b, c], in a fixed order.
__global__ void __launch_bounds__(BOX_THREADS)
sink_reduce_kernel(const double* __restrict__ sink_part, int nblocks, int nc,
                   double* __restrict__ sinks)
{
    __shared__ double buf[BOX_THREADS];
    for (int c = 0; c < nc; ++c) {
        double s = 0.0;
        for (int b = threadIdx.x; b < nblocks; b += BOX_THREADS)
            s += sink_part[(long long)b * nc + c];
        buf[threadIdx.x] = s;
        __syncthreads();
        for (int w = BOX_THREADS / 2; w > 0; w >>= 1) {
            if (threadIdx.x < w) buf[threadIdx.x] += buf[threadIdx.x + w];
            __syncthreads();
        }
        if (threadIdx.x == 0) sinks[c] = buf[0];
        __syncthreads();
    }
}

extern "C" int box_action_threads(void) { return BOX_THREADS; }

extern "C" int box_action_params_size(void) { return (int)sizeof(BoxParams); }

// Launches both kernels on ``stream`` of CUDA device ``device``; returns
// cudaGetLastError() of the launches (0 = cudaSuccess).  sink_part holds
// nblocks * max(nc, 1) doubles.
extern "C" int box_action_launch(const BoxParams* prm,
                                 const void* p, const void* mask,
                                 const void* a, const void* viol,
                                 void* dp, void* sink_part, void* sinks,
                                 int nblocks, int device, void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
    if (prm->R > BOX_MAX_R || prm->S > BOX_MAX_S || prm->nc > BOX_MAX_NC
            || nblocks < 1)
        return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    const double* pp = (const double*)p;
    const uint8_t* mm = (const uint8_t*)mask;
    const double* aa = (const double*)a;
    const int32_t* vv = (const int32_t*)viol;
    double* dd = (double*)dp;
    double* part = (double*)sink_part;
    if (prm->nc <= 8)
        box_action_kernel<8><<<nblocks, BOX_THREADS, 0, st>>>(
            *prm, pp, mm, aa, vv, dd, part);
    else
        box_action_kernel<BOX_MAX_NC><<<nblocks, BOX_THREADS, 0, st>>>(
            *prm, pp, mm, aa, vv, dd, part);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if (prm->nc > 0) {
        sink_reduce_kernel<<<1, BOX_THREADS, 0, st>>>(
            part, nblocks, prm->nc, (double*)sinks);
        e = cudaGetLastError();
    }
    return (int)e;
}
