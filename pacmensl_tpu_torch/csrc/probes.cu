// Bandwidth probes for NVIDIA Hopper (sm_90a): the stream copy that is the
// denominator of the box kernel's roofline fraction, and three probes of
// the box kernel's memory path.
//
// Replaces four Pallas TPU kernels:
//
//   * stream_copy (K5): bench.py _copy_kernel / pcopy (:167-179, call
//     :170), out = x, over a buffer of max(n_box, 2^26) elements;
//   * scaled_copy (K6): tools/bw_probe.py copy (:53-59, call :57),
//     out = x * 1.0000001;
//   * window_copy (K7): tools/bw_probe.py win (:69-78, call :75), for each
//     block g of T rows of L: out_g = c * concat(prev_g, x_g, next_g)[H:H+T]
//     with halo blocks prev_g, next_g of H rows;
//   * roll_window (K8): tools/bw_probe.py roll (:91-107, call :104), over
//     the flat window w_g = concat(prev_g, x_g, next_g) of (T + 2H) L
//     elements: out_g[j] = sum_k c * w_g[H L + j - k], the shifts k taken
//     in the caller's order (the reference's are the flat strides of a
//     141^3 box, +-19881, +-141, +-1; its lane roll, two row rolls and
//     select make exactly this flat shift).
//
// What bounds them on this card: bytes.  K5-K7 read n elements and write n
// with at most one multiply each.  K8 reads x, the halo elements its
// shifts reach and writes out, with 2 operations per shift and element,
// far below the card's float rates.
//
// Design.  K5-K7 are one pass of 16-byte vector loads and stores (float4 /
// double2) with streaming cache hints, one vector a thread over a grid
// that covers the buffer (a grid-stride loop takes any excess), and a
// scalar tail of fewer than one vector.  On the H100 this streamed 9%
// more than a grid of 8 resident blocks per SM with four vectors a
// thread in flight (PERF.md, Findings).  A base pointer that is not
// 16-byte aligned is refused (the wrapper raises), never served by a
// scalar path.
// The TPU's K7 copies the halo blocks into VMEM although they never reach
// the output.  Here the window's middle is x itself (out_g[j] = c x_g[j]
// for j < T L), so K7 is K6's pass with the factor c and reads no halo.
// K8 runs one thread per output element in a grid-stride loop over a
// grid of (column blocks, g) of 8 resident blocks per SM in all (on the
// H100 this took 294 us at G = 96 where a grid covering every output took
// 475 us; PERF.md, Findings), and reads its window values straight from device memory.  There is no
// staging: a shift of 141^2 does not fit a shared-memory tile, and these
// are the reads K1 makes of p at its six source offsets, with L1 and L2
// serving the reuse.  Where every source of an output lies in x_g (all but
// the first max k and the last -min k outputs of a block) it reads x_g at
// j - k; elsewhere it takes each value from prev, x or next by where
// H L + j - k falls.  Offsets inside a block are 32-bit (the wrapper
// checks (T + 2H) L < 2^31), block bases 64-bit.  K8 adds c * w in the
// shift order starting from 0; built with -fmad=false, every product and
// sum is rounded as in the plain PyTorch version, so the output is bitwise
// the plain version's.
#include <cstdint>
#include <cuda_runtime.h>

#define PROBE_THREADS 256
// K8's grid: resident blocks per SM (2048 threads at 256 a block)
#define PROBE_BLOCKS_PER_SM 8
#define PROBE_MAX_SHIFTS 8
// bw_probe.py:54's factor, rounded to the tensor's type as the plain
// version's Python float is
#define SCALED_COPY_FACTOR 1.0000001

template <typename T> struct Vec16;
template <> struct Vec16<float> {
    typedef float4 type;
    static constexpr int width = 4;
    static __device__ __forceinline__ float4 mul(float4 v, float s)
    {
        return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
    }
};
template <> struct Vec16<double> {
    typedef double2 type;
    static constexpr int width = 2;
    static __device__ __forceinline__ double2 mul(double2 v, double s)
    {
        return make_double2(v.x * s, v.y * s);
    }
};

// out = x (SCALE false) or x * s (SCALE true) over n elements.
template <typename T, bool SCALE>
__global__ void __launch_bounds__(PROBE_THREADS)
stream_kernel(const T* __restrict__ x, T* __restrict__ out, long long n, T s)
{
    typedef typename Vec16<T>::type V;
    const long long nv = n / Vec16<T>::width;
    const V* __restrict__ xv = reinterpret_cast<const V*>(x);
    V* __restrict__ ov = reinterpret_cast<V*>(out);
    const long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long i = i0; i < nv; i += step) {
        V v = __ldcs(xv + i);
        if constexpr (SCALE)
            v = Vec16<T>::mul(v, s);
        __stcs(ov + i, v);
    }
    const long long t = nv * Vec16<T>::width + i0;   // the scalar tail
    if (t < n) {
        if constexpr (SCALE)
            out[t] = x[t] * s;
        else
            out[t] = x[t];
    }
}

// The shifts by value, with |k| <= H L (checked at launch), so H L + j - k
// lies in the window; kmax and kmin are their largest and least.
struct Shifts {
    int k[PROBE_MAX_SHIFTS];
    int n, kmax, kmin;
};

// Block g = blockIdx.y; the block's threads stride over its T L outputs.
template <typename T>
__global__ void __launch_bounds__(PROBE_THREADS)
roll_window_kernel(T c, const T* __restrict__ x, const T* __restrict__ prev,
                   const T* __restrict__ next, T* __restrict__ out, int TL,
                   int HL, Shifts sh)
{
    const long long g = blockIdx.y;
    const T* __restrict__ xg = x + g * TL;
    const T* __restrict__ pg = prev + g * HL;
    const T* __restrict__ ng = next + g * HL;
    T* __restrict__ og = out + g * TL;
    const int step = gridDim.x * blockDim.x;
    for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < TL; j += step) {
        T acc = T(0);
        if (j >= sh.kmax && j < TL + sh.kmin) {     // every source in x_g
#pragma unroll
            for (int s = 0; s < PROBE_MAX_SHIFTS; ++s)
                if (s < sh.n) acc = acc + c * xg[j - sh.k[s]];
        } else {
#pragma unroll
            for (int s = 0; s < PROBE_MAX_SHIFTS; ++s) {
                if (s < sh.n) {
                    const int w = HL + j - sh.k[s];     // window index
                    const T v = w < HL ? pg[w]
                              : (w < HL + TL ? xg[w - HL] : ng[w - HL - TL]);
                    acc = acc + c * v;
                }
            }
        }
        og[j] = acc;
    }
}

// Blocks of PROBE_THREADS that cover ``work`` threads (at least one, at
// most the grid's limit; a grid-stride loop takes any excess).
static unsigned cover(long long work)
{
    long long b = (work + PROBE_THREADS - 1) / PROBE_THREADS;
    return (unsigned)(b < 1 ? 1 : (b > 0x7fffffffLL ? 0x7fffffffLL : b));
}

// The launch's device current (set only where another is: a CUDA graph
// being captured on this thread needs no device change).
static cudaError_t use_device(int device)
{
    int cur = -1;
    cudaError_t e = cudaGetDevice(&cur);
    if (e != cudaSuccess || cur == device) return e;
    return cudaSetDevice(device);
}

static bool aligned16(const void* p)
{
    return ((uintptr_t)p & 15u) == 0;
}

template <typename T, bool SCALE>
static cudaError_t launch_stream(const void* x, void* out, long long n,
                                 double s, cudaStream_t st)
{
    stream_kernel<T, SCALE><<<cover(n / Vec16<T>::width + 1),
                              PROBE_THREADS, 0, st>>>(
        (const T*)x, (T*)out, n, (T)s);
    return cudaGetLastError();
}

static int stream_launch(bool scale, const void* x, void* out, long long n,
                         double s, int dbl, int device, void* stream)
{
    if (n < 0) return (int)cudaErrorInvalidValue;
    if (!aligned16(x) || !aligned16(out))
        return (int)cudaErrorMisalignedAddress;
    cudaError_t e = use_device(device);
    if (e != cudaSuccess) return (int)e;
    if (n == 0) return (int)cudaSuccess;
    cudaStream_t st = (cudaStream_t)stream;
    if (dbl)
        e = scale ? launch_stream<double, true>(x, out, n, s, st)
                  : launch_stream<double, false>(x, out, n, s, st);
    else
        e = scale ? launch_stream<float, true>(x, out, n, s, st)
                  : launch_stream<float, false>(x, out, n, s, st);
    return (int)e;
}

extern "C" int probe_max_shifts(void) { return PROBE_MAX_SHIFTS; }

// K5: out = x over n elements of float (dbl = 0) or double (dbl = 1), on
// ``stream`` of CUDA device ``device``; returns cudaGetLastError() of the
// launch (0 = cudaSuccess), cudaErrorMisalignedAddress where x or out is
// not 16-byte aligned.
extern "C" int stream_copy_launch(const void* x, void* out, long long n,
                                  int dbl, int device, void* stream)
{
    return stream_launch(false, x, out, n, 0.0, dbl, device, stream);
}

// K6: out = x * 1.0000001, as K5.
extern "C" int scaled_copy_launch(const void* x, void* out, long long n,
                                  int dbl, int device, void* stream)
{
    return stream_launch(true, x, out, n, SCALED_COPY_FACTOR, dbl, device,
                         stream);
}

// K7: out = c * (the middle T rows of each window) = c * x over the n = G
// T L elements of x; the halo blocks never reach the output, so they are
// not passed (the wrapper checks their shapes).
extern "C" int window_copy_launch(double c, const void* x, void* out,
                                  long long n, int dbl, int device,
                                  void* stream)
{
    return stream_launch(true, x, out, n, c, dbl, device, stream);
}

// K8 on G blocks (G <= 65535, (T + 2H) L < 2^31): x and out [G T, L],
// prev and next [G H, L], ``shifts`` nshifts <= PROBE_MAX_SHIFTS flat
// offsets with |k| <= H L.
extern "C" int roll_window_launch(double c, const void* x, const void* prev,
                                  const void* next, void* out, long long G,
                                  long long T, long long H, long long L,
                                  const long long* shifts, int nshifts,
                                  int dbl, int device, void* stream)
{
    if (G < 0 || G > 65535 || T < 0 || H < 0 || L < 0
            || (T + 2 * H) * L >= (1LL << 31) || nshifts < 1
            || nshifts > PROBE_MAX_SHIFTS)
        return (int)cudaErrorInvalidValue;
    const long long TL = T * L, HL = H * L;
    Shifts sh = {};
    sh.n = nshifts;
    sh.kmax = -(int)HL;
    sh.kmin = (int)HL;
    for (int s = 0; s < nshifts; ++s) {
        if (shifts[s] > HL || -shifts[s] > HL)
            return (int)cudaErrorInvalidValue;
        sh.k[s] = (int)shifts[s];
        sh.kmax = sh.k[s] > sh.kmax ? sh.k[s] : sh.kmax;
        sh.kmin = sh.k[s] < sh.kmin ? sh.k[s] : sh.kmin;
    }
    cudaError_t e = use_device(device);
    if (e != cudaSuccess) return (int)e;
    if (G == 0 || TL == 0) return (int)cudaSuccess;
    int sms = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return (int)e;
    long long per_g = ((long long)sms * PROBE_BLOCKS_PER_SM + G - 1) / G;
    if (per_g > (long long)cover(TL)) per_g = cover(TL);
    dim3 grid((unsigned)per_g, (unsigned)G);
    cudaStream_t st = (cudaStream_t)stream;
    if (dbl)
        roll_window_kernel<double><<<grid, PROBE_THREADS, 0, st>>>(
            c, (const double*)x, (const double*)prev, (const double*)next,
            (double*)out, (int)TL, (int)HL, sh);
    else
        roll_window_kernel<float><<<grid, PROBE_THREADS, 0, st>>>(
            (float)c, (const float*)x, (const float*)prev,
            (const float*)next, (float*)out, (int)TL, (int)HL, sh);
    return (int)cudaGetLastError();
}
