// Fused action of the truncated CME generator on a dense state box, with
// the sink derivatives, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel PallasBoxKernel
// (pacmensl_tpu/ops/pallas_box.py, _compute at :437-570, single block at
// :583-602, grid-tiled at :603-640) in two modes that share one body:
//
//   * mask-reading (K1/K2): the validity mask and the violation bits are
//     read from device memory (box_action_launch);
//   * synthesized mask (K3, synth_mask=True, mask synthesis at
//     pallas_box.py:477-489): used when the mask is exactly "every
//     constraint holds" (BoxStateSpace.mask_is_constraint_only).  The mask
//     at x and at each source x - s_r, and the violation bits at each
//     target x + s_r, are computed in registers from a closed form of the
//     constraint scores and the epoch's bounds, both passed by value in
//     the parameter struct (box_action_synth_launch):
//
//       f_c(y) = [y_g == v] * (sum_d w_cd y_d + sum_k u_ck y_i y_j),
//
//     evaluated exactly in int64: the ungated part q once per element,
//     and at x -/+ s_r from q and a per-block table of its change along
//     s_r (a linear function of x for these at most quadratic forms),
//     only for the constraints that reaction r can break.  It reads
//     neither the mask nor the violation words, and visits reactions and
//     constraints in K1's order with the same arithmetic, so where the
//     mask is constraint-only its dp and sinks are bitwise K1's;
//   * sharded (K4, PallasBoxKernel with global_extent0 set,
//     pallas_box.py:220-229, 460-496, 542-546, driven by
//     parallel/halo_box.py): either mode on a window of axis-0 planes of
//     a box split into slabs over ranks.  Window row 0 sits at global row
//     origin0; the kernel computes dp and sinks only for the window's rows
//     [out_lo, out_hi) (the rows the rank owns), evaluates the forms and
//     tests axis-0 source validity at global coordinates against the
//     global extent g0, and keeps flat offsets local to the window.  The
//     rows around the output rows are the neighbours' halo planes.  Sinks
//     come only from the rows the kernel writes, so a sum over the ranks
//     counts each transition once.  K1 and K3 are the window that is the
//     whole box (origin0 = 0, g0 = shape[0], all rows out), so each
//     slab's dp is bitwise the whole box's dp on its rows.
//
// For every flat C-order box index x:
//
//   ap_r(x)  = mask(x) ? a_r(x) * p(x) : 0
//   dp(x)    = sum_r c_r [ (mask(x) && srcok_r(x) ? ap_r(x - s_r) : 0) - ap_r(x) ]
//   sink_c   = sum_r c_r sum_x [bit c of viol_r(x)] * ap_r(x)
//
// srcok_r is the per-axis one-sided test that the source x - s_r lies in
// the box (pallas_box.py:525-539), on int32 coordinates decoded from the
// flat index (below 2^31) by a multiply and shift per axis, axis 0 in
// global coordinates.  A transition counts in
// every constraint it violates (reference sink semantics,
// FspMatrixConstrained.cpp:173-195).
//
// Inputs the TPU kernel recomputes in registers are read here instead:
// the propensity fields a[R, n] (evaluated once per box capacity by the
// caller's torch propensity, the reference's materialize=True variant) and
// the bit-packed violation masks viol[R, n] (bit c = f_c(x + s_r) > b_c,
// evaluated once per expansion epoch).  Recomputing propensities in
// registers, as the TPU kernel does, is the first performance step.
//
// What bounds it on this card.  The mask-reading mode is bound by memory
// traffic: per element it reads p, the mask, R propensity values, R
// violation words and up to R shifted (p, a, mask) sources (mostly L2
// hits), and writes dp, about 8 + 1 + 12R bytes of compulsory traffic.
// The synthesized-mask mode drops the mask and the violation words
// (8 + 8R bytes) but issues the form's integer arithmetic, and on the
// H100 it is slower than the mask-reading mode at every shape timed
// (PERF.md, Findings).  The forms are evaluated in int32 where the host
// shows that no value can overflow it, else in int64.  K4 moves the same
// bytes per output element, plus the halo planes' reads of its window.
//
// The design keeps one thread per flat index in a grid-stride loop over a
// fixed grid (so every launch makes the same reduction tree), selects
// rather than multiplies by the mask (an inf or NaN propensity at an
// invalid position never reaches a
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
#define BOX_MAX_FNC 16   // constraints a form may describe (K3)
#define BOX_MAX_PROD 2   // product terms of one constraint's form
#define BOX_MAX_N 0x7fffffffLL   // box elements: indices decode in 32 bits

// Least resident blocks per SM that the synthesized-mask kernel is
// compiled for: it caps its registers at 64.  On the H100 4 was faster
// than 2, 3 and 5 at every shape timed (PERF.md, Findings).
#define BOX_SYNTH_MIN_BLOCKS 4

// One constraint's closed form (statespace/constraints.py ConstraintForm).
struct BoxForm {
    int w[BOX_MAX_S];      // linear weights w_d
    int pu[BOX_MAX_PROD];  // product coefficients u_k (0: unused term)
    int pi[BOX_MAX_PROD];  // product factors y_i * y_j
    int pj[BOX_MAX_PROD];
    int gate;              // gate axis g, or -1 for no gate
    int gate_val;          // gate value v
};

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
    long long bounds[BOX_MAX_FNC];     // K3: the epoch's constraint bounds
    BoxForm form[BOX_MAX_FNC];         // K3: the constraint forms
    // x / shape[d] = (x * dmul[d]) >> dshift[d] for 0 <= x < 2^31, with
    // dmul = ceil(2^dshift / shape[d]) and dshift = 31 + ceil(log2 shape[d])
    unsigned long long dmul[BOX_MAX_S];
    int dshift[BOX_MAX_S];
    // The window (K4; the whole box for K1 and K3): global row of window
    // row 0, global axis-0 extent, output rows [out_lo, out_hi) of the
    // window, elements per axis-0 plane, and the element stride between
    // reactions in a and viol (n, or more where they are row ranges of a
    // larger window).
    long long origin0;
    long long g0;
    long long out_lo;
    long long out_hi;
    long long plane;
    long long rstride;
};

// y[i] for a run-time i, by selection over the unrolled axes, so that y
// stays in registers.
__device__ __forceinline__ int pick(const int (&y)[BOX_MAX_S], int i)
{
    int v = 0;
#pragma unroll
    for (int d = 0; d < BOX_MAX_S; ++d)
        if (d == i) v = y[d];
    return v;
}

__device__ __forceinline__ bool has_products(const BoxForm& f)
{
    bool any = false;
#pragma unroll
    for (int k = 0; k < BOX_MAX_PROD; ++k) any = any || f.pu[k] != 0;
    return any;
}

// The ungated part q(x) = sum_d w_d x_d + sum_k u_k x_i x_j of a form, in
// the form arithmetic type F.
template <typename F>
__device__ __forceinline__ F form_inner(const BoxForm& f, int S,
                                        const int (&x)[BOX_MAX_S])
{
    F v = 0;
#pragma unroll
    for (int d = 0; d < BOX_MAX_S; ++d)
        if (d < S && f.w[d] != 0) v += (F)f.w[d] * x[d];
#pragma unroll
    for (int k = 0; k < BOX_MAX_PROD; ++k)
        if (f.pu[k] != 0)
            v += (F)f.pu[k] * pick(x, f.pi[k]) * pick(x, f.pj[k]);
    return v;
}

// f(x + SGN s_r) > b, from q = q(x) and the change of q along s_r:
//   q(x + SGN s_r) = q(x) + SGN (dl + g . x) + d2,
// exact for a form of at most quadratic terms.  gs = s_r at the gate axis.
template <int SGN, typename F>
__device__ __forceinline__ bool shifted_over(const BoxForm& f, F b, F q,
                                             F dl, F d2, const int* g,
                                             int gs, int S,
                                             const int (&x)[BOX_MAX_S])
{
    F v = dl;
    if (has_products(f)) {
#pragma unroll
        for (int d = 0; d < BOX_MAX_S; ++d)
            if (d < S) v += (F)g[d] * x[d];
    }
    v = q + SGN * v + d2;
    if (f.gate >= 0 && pick(x, f.gate) + SGN * gs != f.gate_val) v = 0;
    return v > b;
}

// C-order coordinates of window index idx < 2^31, by a multiply and shift
// per axis; axis 0 in global coordinates (window row + origin0).
__device__ __forceinline__ void decode(long long idx, const BoxParams& prm,
                                       int (&crd)[BOX_MAX_S])
{
    unsigned x = (unsigned)idx;
#pragma unroll
    for (int d = BOX_MAX_S - 1; d > 0; --d) {
        if (d < prm.S) {
            const unsigned q = (unsigned)(
                ((unsigned long long)x * prm.dmul[d]) >> prm.dshift[d]);
            crd[d] = (int)(x - q * (unsigned)prm.shape[d]);
            x = q;
        } else {
            crd[d] = 0;
        }
    }
    crd[0] = (int)x + (int)prm.origin0;
}

// NCM: a compile-time bound on the constraint count; SYNTH: the mode; F:
// the type the synthesized-mask mode evaluates the forms in (int where
// the host has shown that no value overflows it, else long long).
template <int NCM, bool SYNTH, typename F>
__global__ void __launch_bounds__(BOX_THREADS,
                                  SYNTH ? BOX_SYNTH_MIN_BLOCKS : 1)
box_action_kernel(const __grid_constant__ BoxParams prm,
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

    // K3, per block: for constraint c and reaction r the change of the
    // ungated part along s_r (dl, d2, g; see shifted_over), and the
    // constraints that can break at x - s_r (t_src[r]) and at x + s_r
    // (t_tgt[r]) where they hold at x.  A constraint whose species r does
    // not move keeps its value; a linear one without a gate grows along
    // s_r only if dl > 0.
    constexpr int NT = SYNTH ? NCM : 1;
    __shared__ F t_dl[NT][BOX_MAX_R];
    __shared__ F t_d2[NT][BOX_MAX_R];
    __shared__ int t_g[NT][BOX_MAX_R][BOX_MAX_S];
    __shared__ unsigned t_src[SYNTH ? BOX_MAX_R : 1];
    __shared__ unsigned t_tgt[SYNTH ? BOX_MAX_R : 1];
    if constexpr (SYNTH) {
        for (int i = threadIdx.x; i < NCM * BOX_MAX_R; i += blockDim.x) {
            const int c = i / BOX_MAX_R;
            const int r = i - c * BOX_MAX_R;
            F dl = 0, d2 = 0;
            for (int d = 0; d < BOX_MAX_S; ++d) t_g[c][r][d] = 0;
            if (c < prm.nc && r < prm.R) {
                const BoxForm& f = prm.form[c];
                const int* s = prm.stoich[r];
                for (int d = 0; d < prm.S; ++d) dl += (F)f.w[d] * s[d];
                for (int k = 0; k < BOX_MAX_PROD; ++k) {
                    if (f.pu[k] == 0) continue;
                    const int i0 = f.pi[k], j0 = f.pj[k];
                    d2 += (F)f.pu[k] * s[i0] * s[j0];
                    t_g[c][r][i0] += f.pu[k] * s[j0];
                    t_g[c][r][j0] += f.pu[k] * s[i0];
                }
            }
            t_dl[c][r] = dl;
            t_d2[c][r] = d2;
        }
        __syncthreads();
        if (threadIdx.x < BOX_MAX_R) {
            const int r = threadIdx.x;
            unsigned ms = 0u, mt = 0u;
            for (int c = 0; c < prm.nc && r < prm.R; ++c) {
                const BoxForm& f = prm.form[c];
                const F dl = t_dl[c][r];
                bool moved = dl != 0 || t_d2[c][r] != 0
                             || (f.gate >= 0 && prm.stoich[r][f.gate] != 0);
                for (int d = 0; d < prm.S; ++d)
                    moved = moved || t_g[c][r][d] != 0;
                const bool lin = !has_products(f) && f.gate < 0;
                if (moved && (!lin || dl < 0)) ms |= 1u << c;
                if (moved && (!lin || dl > 0)) mt |= 1u << c;
            }
            t_src[r] = ms;
            t_tgt[r] = mt;
        }
        __syncthreads();
    }

    // Output element k is window element lo + k: a thread takes the same
    // output elements whatever the window's origin, so a one-slab window
    // reduces its sinks in the whole box's order.
    const long long lo = prm.out_lo * prm.plane;
    const long long nout = (prm.out_hi - prm.out_lo) * prm.plane;
    const long long rs = prm.rstride;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         k < nout; k += stride) {
        const long long idx = lo + k;
        double acc = 0.0;
        int crd[BOX_MAX_S];
        F q[NT];   // K3: each constraint's ungated part at x
        bool valid;
        if constexpr (SYNTH) {
            decode(idx, prm, crd);
            // the synthesized mask is false outside the global box
            valid = crd[0] >= 0 && crd[0] < prm.g0;
#pragma unroll
            for (int c = 0; c < NCM; ++c) {
                if (c < prm.nc) {
                    const BoxForm& f = prm.form[c];
                    q[c] = form_inner<F>(f, prm.S, crd);
                    const bool on = f.gate < 0
                                    || pick(crd, f.gate) == f.gate_val;
                    if ((on ? q[c] : (F)0) > (F)prm.bounds[c]) valid = false;
                }
            }
        } else {
            valid = mask[idx] != 0;
            if (valid) decode(idx, prm, crd);
        }
        if (valid) {
            const double pv = p[idx];
            for (int r = 0; r < prm.R; ++r) {
                const double cr = prm.c[r];
                const long long off = (long long)r * rs;
                const double ap = a[off + idx] * pv;
                bool ok = true;
#pragma unroll
                for (int d = 0; d < BOX_MAX_S; ++d) {
                    if (d < prm.S) {
                        const int s = prm.stoich[r][d];
                        const long long hi = d == 0 ? prm.g0 : prm.shape[d];
                        if (s > 0) ok = ok && (crd[d] - s >= 0);
                        else if (s < 0) ok = ok && (crd[d] - s < hi);
                    }
                }
                double in = 0.0;
                if (ok) {
                    const long long src = idx - prm.kflat[r];
                    bool src_valid;
                    if constexpr (SYNTH) {
                        src_valid = true;
                        const unsigned ev = t_src[r];
#pragma unroll
                        for (int c = 0; c < NCM; ++c) {
                            if ((ev >> c) & 1u) {
                                const BoxForm& f = prm.form[c];
                                const int gs = f.gate >= 0
                                               ? prm.stoich[r][f.gate] : 0;
                                if (shifted_over<-1, F>(
                                        f, (F)prm.bounds[c], q[c],
                                        t_dl[c][r], t_d2[c][r], t_g[c][r],
                                        gs, prm.S, crd))
                                    src_valid = false;
                            }
                        }
                    } else {
                        src_valid = mask[src] != 0;
                    }
                    if (src_valid) in = a[off + src] * p[src];
                }
                acc += cr * (in - ap);
                uint32_t bits;
                if constexpr (SYNTH) {
                    // targets outside the box are evaluated as they are
                    bits = 0u;
                    const unsigned ev = t_tgt[r];
#pragma unroll
                    for (int c = 0; c < NCM; ++c) {
                        if ((ev >> c) & 1u) {
                            const BoxForm& f = prm.form[c];
                            const int gs = f.gate >= 0
                                           ? prm.stoich[r][f.gate] : 0;
                            if (shifted_over<1, F>(
                                    f, (F)prm.bounds[c], q[c], t_dl[c][r],
                                    t_d2[c][r], t_g[c][r], gs, prm.S, crd))
                                bits |= 1u << c;
                        }
                    }
                } else {
                    bits = (uint32_t)viol[off + idx];
                }
                if (bits) {
#pragma unroll
                    for (int c = 0; c < NCM; ++c)
                        if ((bits >> c) & 1u) sk[c] += cr * ap;
                }
            }
        }
        dp[k] = acc;
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

extern "C" int box_action_max_form_constraints(void) { return BOX_MAX_FNC; }

// The window's fields describe rows of a box of fewer than 2^31 elements
// whose global axis-0 coordinates fit an int (the wrapper checks more:
// that every source an output row reads lies in the window).
static bool window_ok(const BoxParams* prm)
{
    return prm->n <= BOX_MAX_N && prm->plane >= 1
        && prm->shape[0] * prm->plane == prm->n
        && 0 <= prm->out_lo && prm->out_lo <= prm->out_hi
        && prm->out_hi <= prm->shape[0] && prm->rstride >= prm->n
        && prm->g0 >= 1 && prm->g0 <= BOX_MAX_N
        && prm->origin0 > -BOX_MAX_N && prm->origin0 < BOX_MAX_N
        && prm->origin0 + prm->out_lo >= 0
        && prm->origin0 + prm->out_hi <= prm->g0;
}

template <int NCM, bool SYNTH, typename F>
static cudaError_t launch_pair(const BoxParams* prm, const double* p,
                               const uint8_t* mask, const double* a,
                               const int32_t* viol, double* dp, double* part,
                               double* sinks, int nblocks, cudaStream_t st)
{
    box_action_kernel<NCM, SYNTH, F><<<nblocks, BOX_THREADS, 0, st>>>(
        *prm, p, mask, a, viol, dp, part);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    if (prm->nc > 0) {
        sink_reduce_kernel<<<1, BOX_THREADS, 0, st>>>(
            part, nblocks, prm->nc, sinks);
        e = cudaGetLastError();
    }
    return e;
}

// Launches the mask-reading kernel (K1, or K4 on a window) and the sink
// reduction on ``stream`` of CUDA device ``device``; returns
// cudaGetLastError() of the launches (0 = cudaSuccess).  dp holds the
// (out_hi - out_lo) * plane output elements; sink_part holds
// nblocks * max(nc, 1) doubles.
extern "C" int box_action_launch(const BoxParams* prm,
                                 const void* p, const void* mask,
                                 const void* a, const void* viol,
                                 void* dp, void* sink_part, void* sinks,
                                 int nblocks, int device, void* stream)
{
    if (prm->R > BOX_MAX_R || prm->S > BOX_MAX_S || prm->nc > BOX_MAX_NC
            || !window_ok(prm) || nblocks < 1)
        return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    cudaStream_t st = (cudaStream_t)stream;
    const double* pp = (const double*)p;
    const uint8_t* mm = (const uint8_t*)mask;
    const double* aa = (const double*)a;
    const int32_t* vv = (const int32_t*)viol;
    double* out = (double*)dp;
    double* part = (double*)sink_part;
    double* sk = (double*)sinks;
    if (prm->nc <= 8)
        e = launch_pair<8, false, long long>(prm, pp, mm, aa, vv, out, part,
                                             sk, nblocks, st);
    else
        e = launch_pair<BOX_MAX_NC, false, long long>(prm, pp, mm, aa, vv,
                                                      out, part, sk, nblocks,
                                                      st);
    return (int)e;
}

// The same for the synthesized-mask kernel (K3, or K4 on a window): no
// mask, no violation words; prm->bounds and prm->form describe the
// constraints.  narrow = 1
// evaluates the forms in int32, which the caller allows only where no
// value at any box point or its neighbours can overflow it (the result is
// then the int64 evaluation's).
extern "C" int box_action_synth_launch(const BoxParams* prm,
                                       const void* p, const void* a,
                                       void* dp, void* sink_part, void* sinks,
                                       int nblocks, int narrow, int device,
                                       void* stream)
{
    if (prm->R > BOX_MAX_R || prm->S > BOX_MAX_S || prm->nc > BOX_MAX_FNC
            || !window_ok(prm) || nblocks < 1)
        return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    cudaStream_t st = (cudaStream_t)stream;
    const double* pp = (const double*)p;
    const double* aa = (const double*)a;
    double* out = (double*)dp;
    double* part = (double*)sink_part;
    double* sk = (double*)sinks;
    if (prm->nc <= 8 && narrow)
        e = launch_pair<8, true, int>(prm, pp, nullptr, aa, nullptr, out,
                                      part, sk, nblocks, st);
    else if (prm->nc <= 8)
        e = launch_pair<8, true, long long>(prm, pp, nullptr, aa, nullptr,
                                            out, part, sk, nblocks, st);
    else if (narrow)
        e = launch_pair<BOX_MAX_FNC, true, int>(prm, pp, nullptr, aa,
                                                nullptr, out, part, sk,
                                                nblocks, st);
    else
        e = launch_pair<BOX_MAX_FNC, true, long long>(prm, pp, nullptr, aa,
                                                      nullptr, out, part, sk,
                                                      nblocks, st);
    return (int)e;
}
