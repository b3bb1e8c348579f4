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
// K8 stages what each block of outputs reads in shared memory.  A block
// takes spans of SPAN = 256 x ROLL_VPT x (16 / sizeof(T)) consecutive
// outputs of one window (4,096 float or 2,048 double; the spans start
// where the output is 16-byte aligned), taking the spans of all windows
// in turn in a grid-stride loop.  The shifts fall into groups whose
// members lie within ROLL_SPREAD elements of each other (the host sorts
// them; 141^3's give three: -19881, the centre -141..141, +19881); for
// each group the block copies the one segment of the window that the
// span reads through that group's shifts, SPAN plus the group's spread,
// into shared memory with cp.async: 16-byte copies (cp.async.cg) where a
// vector of the segment lies in one of prev, x or next and is 16-byte
// aligned there, 4- or 8-byte copies elsewhere (a misaligned base, the
// edges of x and of the halos).  Each segment starts where x's vectors
// do, so inside x every copy is a 16-byte one.  Two stage buffers: the
// block issues the next span's copies before it computes the current
// one.  A thread then takes ROLL_VPT 16-byte vectors of outputs: for each
// shift, in the caller's order, two aligned 16-byte shared-memory reads
// and a select by the shift's offset within a vector (the same for every
// thread), and acc = acc + c * w; it stores each 16 bytes at once
// (scalars at the window's two ends).  The first version, one thread per
// output with six scalar loads from device memory, five of them
// misaligned, was load-issue bound (0.42 of its bound at G = 96,
// PERF.md); the span's width, the order of the spans and the depth of
// the pipeline were chosen by timing variants on an H100 (PERF.md).
// Offsets inside a block are 32-bit (the wrapper checks (T + 2H) L <
// 2^31), block bases 64-bit.  K8 adds c * w in the shift order starting
// from 0; built with -fmad=false, every product and sum is rounded as in
// the plain PyTorch version, so the output is bitwise the plain
// version's.
#include <cstdint>
#include <cuda_runtime.h>

#define PROBE_THREADS 256
// K8's grid: resident blocks per SM (2048 threads at 256 a block)
#define PROBE_BLOCKS_PER_SM 8
#define PROBE_MAX_SHIFTS 8
// K8: shifts within this many elements of their group's least share one
// staged segment; 16-byte output vectors a thread takes in a span, where
// the two stage buffers fit a block's shared memory (else 1)
#define ROLL_SPREAD 1024
#define ROLL_VPT 4
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

// The shifts by value (|k| <= H L, checked at launch, so H L + j - k lies
// in the window) and their groups: shift s belongs to group grp[s]; group
// g's largest shift is gmax[g], and its segment of a stage buffer starts
// at goff[g] (a multiple of the vector width).  ``stage``: elements of
// one stage buffer.
struct RollPlan {
    int k[PROBE_MAX_SHIFTS];
    int grp[PROBE_MAX_SHIFTS];
    int gmax[PROBE_MAX_SHIFTS];
    int goff[PROBE_MAX_SHIFTS + 1];
    int n, ng, stage;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src)
{
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src));
}

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src)
{
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(d), "l"(src), "n"(N));
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one()
{
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}



// The VW elements that start r elements into the vector lo, continuing
// into hi (r is the same for every thread: no divergence).
__device__ __forceinline__ float4 shift_vec(float4 lo, float4 hi, int r)
{
    switch (r) {
    case 0: return lo;
    case 1: return make_float4(lo.y, lo.z, lo.w, hi.x);
    case 2: return make_float4(lo.z, lo.w, hi.x, hi.y);
    default: return make_float4(lo.w, hi.x, hi.y, hi.z);
    }
}

__device__ __forceinline__ double2 shift_vec(double2 lo, double2 hi, int r)
{
    return r == 0 ? lo : make_double2(lo.y, hi.x);
}

__device__ __forceinline__ void add_scaled(float4& acc, float c, float4 w)
{
    acc.x = acc.x + c * w.x;
    acc.y = acc.y + c * w.y;
    acc.z = acc.z + c * w.z;
    acc.w = acc.w + c * w.w;
}

__device__ __forceinline__ void add_scaled(double2& acc, double c, double2 w)
{
    acc.x = acc.x + c * w.x;
    acc.y = acc.y + c * w.y;
}

// Span t of the launch is span m = t % nsp of window g = t / nsp (nsp =
// spans of a window, the same for every window; a span past the
// window's end computes nothing).  Span m holds the window's outputs
// [j0, j0 + SPAN), j0 = m SPAN - oph, where oph puts j0 at a 16-byte
// boundary of out.  Group q's segment for the span starts at window
// index HL + j0 - gmax[q] - pad[q], where x's vectors start; pad[q] is
// the same for every span (x and out lie a fixed number of elements
// apart in every window).  Block b takes spans b, b + gridDim.x, ... of
// all windows in turn, so the blocks work on a few windows at a time and
// a value of x is read from device memory once for the three segments
// that stage it (at G = 96 in float32 and float64 this was 4 and 9%
// faster than a grid of blocks per window, PERF.md).  A thread takes VPT
// vectors of a span, PROBE_THREADS vectors apart.
template <typename T, int VPT>
__global__ void __launch_bounds__(PROBE_THREADS)
roll_window_kernel(T c, const T* __restrict__ x, const T* __restrict__ prev,
                   const T* __restrict__ next, T* __restrict__ out, int TL,
                   int HL, int nsp, long long nspans, const RollPlan pl)
{
    typedef typename Vec16<T>::type V;
    constexpr int VW = Vec16<T>::width;
    constexpr int SPAN = VW * PROBE_THREADS * VPT;
    extern __shared__ __align__(16) unsigned char roll_smem[];
    T* const buf0 = reinterpret_cast<T*>(roll_smem);

    const int W = TL + 2 * HL;                     // window elements
    // x's and out's offsets within a 16-byte vector differ by dph in
    // every window
    const int dph = (int)((((uintptr_t)x - (uintptr_t)out) / sizeof(T))
                          % VW);
    auto pad = [&](int q) {
        return ((dph - pl.gmax[q]) % VW + VW) % VW;
    };
    // each shift's first 16-byte vector in a stage buffer, for thread 0,
    // and its offset within it (the same for every span and thread)
    int sv[PROBE_MAX_SHIFTS], sr[PROBE_MAX_SHIFTS];
#pragma unroll
    for (int s = 0; s < PROBE_MAX_SHIFTS; ++s) {
        const int q = s < pl.n ? pl.grp[s] : 0;
        const int i = s < pl.n
            ? pl.goff[q] + pad(q) + (pl.gmax[q] - pl.k[s]) : 0;
        sv[s] = i / VW;
        sr[s] = i % VW;
    }
    // span t: its window and first output
    auto window_of = [&](long long t, long long& g, int& j0) {
        g = t / nsp;
        const int oph = (int)(((uintptr_t)(out + g * TL) / sizeof(T)) % VW);
        j0 = (int)(t - g * nsp) * SPAN - oph;
    };

    auto stage = [&](long long t, T* buf) {
        long long g;
        int j0;
        window_of(t, g, j0);
        const T* __restrict__ xg = x + g * TL;
        const T* __restrict__ pg = prev + g * HL;
        const T* __restrict__ ng = next + g * HL;
        for (int q = 0; q < pl.ng; ++q) {
            const int w_s = HL + j0 - pl.gmax[q] - pad(q);
            const int nvec = (pl.goff[q + 1] - pl.goff[q]) / VW;
            T* dst = buf + pl.goff[q];
            for (int v = threadIdx.x; v < nvec; v += PROBE_THREADS) {
                const int w0 = w_s + v * VW;
                if (w0 >= HL && w0 <= HL + TL - VW) {
                    // inside x: aligned where x's vectors are
                    cp_async16(dst + v * VW, xg + (w0 - HL));
                    continue;
                }
                // prev, next, the edges of x: 16 bytes where the vector
                // lies in one of them at a 16-byte boundary, else per
                // element
                const T* src = nullptr;
                if (w0 >= 0 && w0 + VW <= HL) src = pg + w0;
                else if (w0 >= HL + TL && w0 + VW <= W)
                    src = ng + (w0 - HL - TL);
                if (src != nullptr && ((uintptr_t)src & 15u) == 0) {
                    cp_async16(dst + v * VW, src);
                    continue;
                }
                for (int e = 0; e < VW; ++e) {
                    const int w = w0 + e;
                    if (w < 0 || w >= W) continue;
                    cp_async<sizeof(T)>(dst + v * VW + e,
                                        w < HL ? pg + w
                                        : w < HL + TL ? xg + (w - HL)
                                                      : ng + (w - HL - TL));
                }
            }
        }
    };

    // the next span's copies in flight while the block computes one
    int cur = 0;
    if (blockIdx.x < nspans) stage(blockIdx.x, buf0);
    cp_async_commit();
    for (long long t = blockIdx.x; t < nspans; t += gridDim.x) {
        if (t + gridDim.x < nspans)
            stage(t + gridDim.x, buf0 + (cur ^ 1) * pl.stage);
        cp_async_commit();
        cp_async_wait_one();
        __syncthreads();        // the span's segments are in place
        const V* bv = reinterpret_cast<const V*>(buf0 + cur * pl.stage)
                      + threadIdx.x;
        V acc[VPT];
#pragma unroll
        for (int i = 0; i < VPT; ++i) {
            if constexpr (VW == 4) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
            else acc[i] = make_double2(0.0, 0.0);
        }
#pragma unroll
        for (int s = 0; s < PROBE_MAX_SHIFTS; ++s) {
            if (s >= pl.n) break;
#pragma unroll
            for (int i = 0; i < VPT; ++i) {
                const V* vp = bv + sv[s] + i * PROBE_THREADS;
                const V lo = vp[0];
                const V hi = sr[s] ? vp[1] : lo;
                add_scaled(acc[i], c, shift_vec(lo, hi, sr[s]));
            }
        }
        long long g;
        int j0;
        window_of(t, g, j0);
        T* __restrict__ og = out + g * TL;
#pragma unroll
        for (int i = 0; i < VPT; ++i) {
            const int j = j0 + VW * ((int)threadIdx.x + i * PROBE_THREADS);
            if (j >= 0 && j + VW <= TL) {
                *reinterpret_cast<V*>(og + j) = acc[i];
            } else {
                const T* a = reinterpret_cast<const T*>(&acc[i]);
                for (int e = 0; e < VW; ++e)
                    if (j + e >= 0 && j + e < TL) og[j + e] = a[e];
            }
        }
        __syncthreads();        // the buffer is free for the span after next
        cur ^= 1;
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

// K8's plan for elements of type T and spans of SPAN outputs: the
// shifts, grouped (sorted, a new group where a shift lies more than
// ROLL_SPREAD beyond its group's least), each group's segment SPAN plus
// its spread plus two vectors.
template <typename T>
static RollPlan roll_plan(const int* k, int n, int SPAN)
{
    constexpr int VW = Vec16<T>::width;
    RollPlan pl = {};
    pl.n = n;
    int srt[PROBE_MAX_SHIFTS];
    for (int s = 0; s < n; ++s) {
        pl.k[s] = k[s];
        int i = s;
        while (i > 0 && srt[i - 1] > k[s]) { srt[i] = srt[i - 1]; --i; }
        srt[i] = k[s];
    }
    int gmin[PROBE_MAX_SHIFTS];
    for (int s = 0; s < n; ++s) {
        if (pl.ng == 0 || srt[s] - gmin[pl.ng - 1] > ROLL_SPREAD) {
            gmin[pl.ng] = srt[s];
            ++pl.ng;
        }
        pl.gmax[pl.ng - 1] = srt[s];
    }
    for (int q = 0; q < pl.ng; ++q) {
        const int spread = pl.gmax[q] - gmin[q];
        pl.goff[q + 1] = pl.goff[q] + SPAN + (spread + VW - 1) / VW * VW
                         + 2 * VW;
    }
    pl.stage = pl.goff[pl.ng];
    for (int s = 0; s < n; ++s) {
        int q = 0;
        while (pl.k[s] < gmin[q] || pl.k[s] > pl.gmax[q]) ++q;
        pl.grp[s] = q;
    }
    return pl;
}

template <typename T, int VPT>
static cudaError_t launch_roll(double c, const void* x, const void* prev,
                              const void* next, void* out, long long G,
                              int TL, int HL, const RollPlan& pl, size_t smem,
                              int sms, cudaStream_t st)
{
    // shared memory beyond 48 KB must be asked for
    static size_t allowed = 48 * 1024;
    if (smem > allowed) {
        cudaError_t e = cudaFuncSetAttribute(
            roll_window_kernel<T, VPT>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
        allowed = smem;
    }
    constexpr int SPAN = Vec16<T>::width * PROBE_THREADS * VPT;
    // spans of a window: enough for any offset of out within a vector
    const int nsp = (TL + Vec16<T>::width - 1 + SPAN - 1) / SPAN;
    const long long nspans = G * nsp;
    const long long most = (long long)sms * PROBE_BLOCKS_PER_SM;
    roll_window_kernel<T, VPT>
        <<<(unsigned)(nspans < most ? nspans : most), PROBE_THREADS, smem,
           st>>>((T)c, (const T*)x, (const T*)prev, (const T*)next, (T*)out,
                 TL, HL, nsp, nspans, pl);
    return cudaGetLastError();
}

// K8 with ROLL_VPT vectors a thread where its two stage buffers fit the
// shared memory a block may have (8 groups of shifts at the most spread
// need 328 KB for float, 394 KB for double; the three groups of the 141^3
// box's shifts 101 and 103 KB), else with one (at most 132 and 197 KB).
template <typename T>
static cudaError_t roll(double c, const void* x, const void* prev,
                        const void* next, void* out, long long G, int TL,
                        int HL, const int* k, int n, int sms, int optin,
                        cudaStream_t st)
{
    constexpr int W1 = Vec16<T>::width * PROBE_THREADS;
    RollPlan pl = roll_plan<T>(k, n, W1 * ROLL_VPT);
    size_t smem = 2 * (size_t)pl.stage * sizeof(T);
    if (smem <= (size_t)optin)
        return launch_roll<T, ROLL_VPT>(c, x, prev, next, out, G, TL, HL, pl,
                                        smem, sms, st);
    pl = roll_plan<T>(k, n, W1);
    smem = 2 * (size_t)pl.stage * sizeof(T);
    return launch_roll<T, 1>(c, x, prev, next, out, G, TL, HL, pl, smem,
                             sms, st);
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
    int k[PROBE_MAX_SHIFTS];
    for (int s = 0; s < nshifts; ++s) {
        if (shifts[s] > HL || -shifts[s] > HL)
            return (int)cudaErrorInvalidValue;
        k[s] = (int)shifts[s];
    }
    cudaError_t e = use_device(device);
    if (e != cudaSuccess) return (int)e;
    if (G == 0 || TL == 0) return (int)cudaSuccess;
    int sms = 0, optin = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (e != cudaSuccess) return (int)e;
    cudaStream_t st = (cudaStream_t)stream;
    e = dbl ? roll<double>(c, x, prev, next, out, G, (int)TL, (int)HL, k,
                           nshifts, sms, optin, st)
            : roll<float>(c, x, prev, next, out, G, (int)TL, (int)HL, k,
                          nshifts, sms, optin, st);
    return (int)e;
}
