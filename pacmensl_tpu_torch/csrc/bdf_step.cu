// Fused vector passes of a BDF step on NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel.  The reference package's BDF step
// (pacmensl_tpu/solvers/bdf.py) is traced by XLA, which fuses its vector
// arithmetic; the port's step (pacmensl_tpu_torch/solvers/bdf.py) ran it
// as separate PyTorch operations, a launch and a pass over the vector
// each.  These four kernels take the step's arithmetic outside GMRES in
// four passes over the pair (p, sinks), one launch each:
//
//   * predict: y = ((D0 + D1) + D2) + ... + Dq and
//     psi = ((g1 D1 + g2 D2) + g3 D3) + ... + gq Dq, g_i = gamma_i / alpha_q
//     (BdfSolver._predict), and both of the step's finiteness flags set to 1;
//   * rhs: out = c a - psi, with a = A(t) y the action (the corrector's
//     right-hand side), and flag 0 set to 0 where an entry is not finite;
//   * post: y_new = y + d and sq = ((errc d) / (rtol |y| + atol))^2, the
//     terms of the error norm (BdfSolver._err_norm_dev before its sums), and
//     flag 1 set to 0 where an entry of y_new is not finite;
//   * update: D[q+2] = d - D[q+1], D[q+1] = d, then D[i] = D[i] + D[i+1]
//     for i = q down to 0 (BdfSolver._update_D).
//
// Each computes every product and sum in the order of the PyTorch
// operations it replaces, and the library is built with -fmad=false, so no
// product is contracted into a multiply-add: the outputs are bitwise those
// operations' (q ** 2 is q * q in PyTorch's pow for the exponent 2, and a
// double division rounds correctly on the card as on the host).
//
// What bounds them: bytes.  Each reads and writes each of its vectors once
// with a few operations an element, far below the card's float rate.
// Design: a grid of at most BDF_BLOCKS_PER_SM blocks an SM walks the p
// part in a grid-stride loop, each thread taking BDF_UNROLL elements one
// grid apart (each warp's access to a row is one coalesced 256-byte
// segment), all of their loads issued before any arithmetic, so a thread
// keeps BDF_UNROLL times its rows' loads in flight; then the sinks part the
// same way, in the same launch.  Rows of the difference array are reached
// through their stride, so no row has to be 16-byte aligned (a row of an
// odd length is not) and no vector path is needed.  The flags are plain
// stores of 0 by the threads that saw a non-finite entry: every such
// store writes the same value.  No kernel allocates or synchronizes; each
// runs on the caller's stream and takes its scalars as arguments.
#include <cuda_runtime.h>
#include <math.h>

#define BDF_THREADS 256
#define BDF_BLOCKS_PER_SM 8
#define BDF_UNROLL 4
#define BDF_MAX_ORDER 5

// The index loop of every pass over one part of n elements: loads of
// BDF_UNROLL elements a grid apart, then their arithmetic and stores.
template <class P>
__device__ __forceinline__ void each(const P& pass, const typename P::Part& a,
                                     bool& ok)
{
    const long long T = (long long)gridDim.x * blockDim.x;
    long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    for (; k + (BDF_UNROLL - 1) * T < a.n; k += BDF_UNROLL * T) {
        typename P::Vals v[BDF_UNROLL];
#pragma unroll
        for (int u = 0; u < BDF_UNROLL; ++u)
            v[u] = pass.load(a, k + u * T);
#pragma unroll
        for (int u = 0; u < BDF_UNROLL; ++u)
            pass.store(a, k + u * T, v[u], ok);
    }
    for (; k < a.n; k += T)
        pass.store(a, k, pass.load(a, k), ok);
}

template <class P>
__global__ void __launch_bounds__(BDF_THREADS) pass_kernel(P pass)
{
    bool ok = true;
    each(pass, pass.p, ok);
    each(pass, pass.s, ok);
    pass.finish(ok);
}

template <int Q>
struct Predict {
    struct Part {
        const double* D;    // row j at D + j * ld
        long long ld;
        double* y;
        double* psi;
        long long n;
    };
    struct Vals { double d[Q + 1]; };
    Part p, s;
    double g[Q + 1];        // g[j] = gamma_j / alpha_q, j >= 1
    double* flags;

    __device__ __forceinline__ Vals load(const Part& a, long long k) const
    {
        Vals v;
#pragma unroll
        for (int j = 0; j <= Q; ++j)
            v.d[j] = a.D[j * a.ld + k];
        return v;
    }
    __device__ __forceinline__ void store(const Part& a, long long k,
                                          const Vals& v, bool&) const
    {
        double y = v.d[0] + v.d[1];
        double psi = g[1] * v.d[1];
#pragma unroll
        for (int j = 2; j <= Q; ++j) {
            y = y + v.d[j];
            psi = psi + g[j] * v.d[j];
        }
        a.y[k] = y;
        a.psi[k] = psi;
    }
    __device__ __forceinline__ void finish(bool) const
    {
        if (blockIdx.x == 0 && threadIdx.x == 0) {
            flags[0] = 1.0;
            flags[1] = 1.0;
        }
    }
};

struct Rhs {
    struct Part {
        const double* a;
        const double* psi;
        double* out;
        long long n;
    };
    struct Vals { double a, psi; };
    Part p, s;
    double c;
    double* flag;

    __device__ __forceinline__ Vals load(const Part& a, long long k) const
    {
        return Vals{a.a[k], a.psi[k]};
    }
    __device__ __forceinline__ void store(const Part& a, long long k,
                                          const Vals& v, bool& ok) const
    {
        const double r = c * v.a - v.psi;
        a.out[k] = r;
        ok = ok && isfinite(r);
    }
    __device__ __forceinline__ void finish(bool ok) const
    {
        if (!ok)
            *flag = 0.0;
    }
};

struct Post {
    struct Part {
        const double* y;
        const double* d;
        double* y_new;
        double* sq;
        long long n;
    };
    struct Vals { double y, d; };
    Part p, s;
    double errc, atol, rtol;
    double* flag;

    __device__ __forceinline__ Vals load(const Part& a, long long k) const
    {
        return Vals{a.y[k], a.d[k]};
    }
    __device__ __forceinline__ void store(const Part& a, long long k,
                                          const Vals& v, bool& ok) const
    {
        const double y_new = v.y + v.d;
        const double r = (errc * v.d) / (rtol * fabs(v.y) + atol);
        a.y_new[k] = y_new;
        a.sq[k] = r * r;
        ok = ok && isfinite(y_new);
    }
    __device__ __forceinline__ void finish(bool ok) const
    {
        if (!ok)
            *flag = 0.0;
    }
};

template <int Q>
struct Update {
    struct Part {
        double* D;          // row j at D + j * ld
        long long ld;
        const double* d;
        long long n;
    };
    struct Vals { double d, D[Q + 2]; };
    Part p, s;

    __device__ __forceinline__ Vals load(const Part& a, long long k) const
    {
        Vals v;
        v.d = a.d[k];
#pragma unroll
        for (int j = 0; j <= Q + 1; ++j)
            v.D[j] = a.D[j * a.ld + k];
        return v;
    }
    __device__ __forceinline__ void store(const Part& a, long long k,
                                          const Vals& v, bool&) const
    {
        a.D[(Q + 2) * a.ld + k] = v.d - v.D[Q + 1];
        a.D[(Q + 1) * a.ld + k] = v.d;
        double acc = v.d;
#pragma unroll
        for (int i = Q; i >= 0; --i) {
            acc = v.D[i] + acc;
            a.D[i * a.ld + k] = acc;
        }
    }
    __device__ __forceinline__ void finish(bool) const {}
};

static cudaError_t use_device(int device)
{
    int cur = -1;
    cudaError_t e = cudaGetDevice(&cur);
    if (e != cudaSuccess || cur == device) return e;
    return cudaSetDevice(device);
}

template <class P>
static int launch(const P& pass, int device, void* stream)
{
    cudaError_t e = use_device(device);
    if (e != cudaSuccess) return (int)e;
    const long long n = pass.p.n > pass.s.n ? pass.p.n : pass.s.n;
    if (n == 0) return (int)cudaSuccess;
    int sms = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return (int)e;
    const long long per = (long long)BDF_THREADS * BDF_UNROLL;
    long long blocks = (n + per - 1) / per;
    const long long most = (long long)sms * BDF_BLOCKS_PER_SM;
    if (blocks > most) blocks = most;
    pass_kernel<P><<<(unsigned)blocks, BDF_THREADS, 0,
                     (cudaStream_t)stream>>>(pass);
    return (int)cudaGetLastError();
}

template <int Q>
static int predict(const double* Dp, long long ldp, double* yp, double* psip,
                   long long n, const double* Ds, long long lds, double* ys,
                   double* psis, long long nc, const double* g,
                   double* flags, int device, void* stream)
{
    Predict<Q> pass;
    pass.p = {Dp, ldp, yp, psip, n};
    pass.s = {Ds, lds, ys, psis, nc};
    pass.g[0] = 0.0;
    for (int j = 1; j <= Q; ++j)
        pass.g[j] = g[j - 1];
    pass.flags = flags;
    return launch(pass, device, stream);
}

template <int Q>
static int update(double* Dp, long long ldp, const double* dp, long long n,
                  double* Ds, long long lds, const double* ds, long long nc,
                  int device, void* stream)
{
    Update<Q> pass;
    pass.p = {Dp, ldp, dp, n};
    pass.s = {Ds, lds, ds, nc};
    return launch(pass, device, stream);
}

extern "C" int bdf_max_order(void) { return BDF_MAX_ORDER; }

// y_pred and psi of order q from the difference array D (p rows ldp apart,
// sink rows lds apart); g: the q coefficients gamma_j / alpha_q, j = 1..q;
// flags: the step's two finiteness flags, set to 1.
extern "C" int bdf_predict_launch(int q, const double* Dp, long long ldp,
                                  double* yp, double* psip, long long n,
                                  const double* Ds, long long lds, double* ys,
                                  double* psis, long long nc, const double* g,
                                  double* flags, int device, void* stream)
{
    switch (q) {
    case 1: return predict<1>(Dp, ldp, yp, psip, n, Ds, lds, ys, psis, nc, g,
                              flags, device, stream);
    case 2: return predict<2>(Dp, ldp, yp, psip, n, Ds, lds, ys, psis, nc, g,
                              flags, device, stream);
    case 3: return predict<3>(Dp, ldp, yp, psip, n, Ds, lds, ys, psis, nc, g,
                              flags, device, stream);
    case 4: return predict<4>(Dp, ldp, yp, psip, n, Ds, lds, ys, psis, nc, g,
                              flags, device, stream);
    case 5: return predict<5>(Dp, ldp, yp, psip, n, Ds, lds, ys, psis, nc, g,
                              flags, device, stream);
    default: return (int)cudaErrorInvalidValue;
    }
}

// out = c a - psi over both parts; flag: set to 0 where out is not finite.
extern "C" int bdf_rhs_launch(double c, const double* ap, const double* psip,
                              double* outp, long long n, const double* as,
                              const double* psis, double* outs, long long nc,
                              double* flag, int device, void* stream)
{
    Rhs pass;
    pass.p = {ap, psip, outp, n};
    pass.s = {as, psis, outs, nc};
    pass.c = c;
    pass.flag = flag;
    return launch(pass, device, stream);
}

// y_new = y + d and sq = ((errc d) / (rtol |y| + atol))^2 over both parts;
// flag: set to 0 where y_new is not finite.
extern "C" int bdf_post_launch(double errc, double atol, double rtol,
                               const double* yp, const double* dp,
                               double* ynp, double* sqp, long long n,
                               const double* ys, const double* ds,
                               double* yns, double* sqs, long long nc,
                               double* flag, int device, void* stream)
{
    Post pass;
    pass.p = {yp, dp, ynp, sqp, n};
    pass.s = {ys, ds, yns, sqs, nc};
    pass.errc = errc;
    pass.atol = atol;
    pass.rtol = rtol;
    pass.flag = flag;
    return launch(pass, device, stream);
}

// The accepted step's difference d pushed into D at order q, in place.
extern "C" int bdf_update_launch(int q, double* Dp, long long ldp,
                                 const double* dp, long long n, double* Ds,
                                 long long lds, const double* ds,
                                 long long nc, int device, void* stream)
{
    switch (q) {
    case 1: return update<1>(Dp, ldp, dp, n, Ds, lds, ds, nc, device, stream);
    case 2: return update<2>(Dp, ldp, dp, n, Ds, lds, ds, nc, device, stream);
    case 3: return update<3>(Dp, ldp, dp, n, Ds, lds, ds, nc, device, stream);
    case 4: return update<4>(Dp, ldp, dp, n, Ds, lds, ds, nc, device, stream);
    case 5: return update<5>(Dp, ldp, dp, n, Ds, lds, ds, nc, device, stream);
    default: return (int)cudaErrorInvalidValue;
    }
}
