// Fused action of the truncated CME generator on a dense state box, with
// the sink derivatives, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel PallasBoxKernel
// (pacmensl_tpu/ops/pallas_box.py, _compute at :437-570, single block at
// :583-602, grid-tiled at :603-640) in modes that share one body:
//
//   * mask-reading (K1/K2): the validity mask and the violation bits are
//     read from device memory;
//   * synthesized mask (K3, synth_mask=True, mask synthesis at
//     pallas_box.py:477-489): used when the mask is exactly "every
//     constraint holds" (BoxStateSpace.mask_is_constraint_only).  The mask
//     at x and at each source x - s_r, and the violation bits at each
//     target x + s_r, are computed in registers from a closed form of the
//     constraint scores (passed by value in the parameter struct) and the
//     epoch's bounds (read from device memory, see "Per-call inputs"):
//
//       f_c(y) = [y_g == v] * (sum_d w_cd y_d + sum_k u_ck y_i y_j),
//
//     evaluated exactly in F (int32 where the host shows no value can
//     overflow it, else int64).  On a row of the last axis (the other
//     coordinates fixed) every form is A + B x in the last coordinate x
//     (the kernel takes no product of the last axis with itself and no
//     gate on it), so where it is violated is an interval of x.  Once per
//     row the kernel forms the interval of valid x, for each reaction the
//     interval of x whose source x - s_r is valid and in the box, and for
//     each constraint c that reaction r can break at its target x + s_r
//     (masks from the host, ops/box_kernel.py synth_masks) the interval
//     of x where it does.  Per element it then only compares x with
//     them.  It visits reactions and constraints in K1's order with the
//     same arithmetic, so where the mask is constraint-only its dp and
//     sinks are bitwise K1's;
//   * sharded (K4, PallasBoxKernel with global_extent0 set,
//     pallas_box.py:220-229, 460-496, 542-546, driven by
//     parallel/halo_box.py): either mode on a window of axis-0 planes of
//     a box split into slabs over ranks.  Window row 0 sits at global row
//     origin0; the kernel computes dp and sinks for the window's rows
//     [out_lo, out_hi), tests axis-0 validity at
//     global coordinates against the global extent g0, and reads p
//     through three base pointers chosen by window row: the halo above
//     (up_rows rows), the rank's slab (mid_rows rows) and the halo below,
//     so no concatenated window is built.  Sinks come only from the rows
//     the kernel writes, so a sum over the ranks counts each transition
//     once.  K1 and K3 are the window that is the whole box;
//   * batched (K9, the jax.vmap of the box action over the sensitivity
//     vectors, pacmensl_tpu/ops/sens_operator.py:150-153, which batches
//     the Pallas call with a leading grid axis): K1 or K3 on nb vectors
//     in one launch with one set of coefficients, tables and mask or
//     bounds.  Everything but p, dp and the sinks is the same for every
//     vector, so a warp takes a unit once for a chunk of up to NBV
//     vectors (blockIdx.y is the chunk): it forms the unit's coordinates,
//     source rows and (K3) intervals once, and per element and reaction
//     the propensities, the source test and the violation bits once; then
//     each vector of the chunk loads its p at x and at the source and
//     adds its own terms.  See "K9" below;
//   * batched on a window (K9w, the jax.vmap of the sharded action: the
//     reference's meshed sensitivity solve vmaps the sharded Pallas call,
//     pacmensl_tpu/ops/sens_operator.py:150-153 over
//     pacmensl_tpu/ops/box_operator.py:152-170): K9 with K4's window
//     fields, on a rank's slab.  Each vector's halos above and below come
//     in p_up and p_dn with batch strides of their own (up_bstride,
//     dn_bstride), so the ranks exchange every vector's edge planes in one
//     message each way.  Like K4 it runs as one launch over the slab,
//     whose last block reduces every vector's sinks once.  Its sinks come
//     from the same per-vector cells and slots as K9's, and each vector's
//     dp and sinks are bitwise a K4 launch's on that vector.  See "K9w"
//     below.
//
// For every C-order box index x:
//
//   ap_r(x)  = mask(x) ? a_r(x) * p(x) : 0
//   dp(x)    = sum_r c_r [ (mask(x) && srcok_r(x) ? ap_r(x - s_r) : 0) - ap_r(x) ]
//   sink_c   = sum_r c_r sum_x [bit c of viol_r(x)] * ap_r(x)
//
// srcok_r is the test that the source x - s_r lies in the box
// (pallas_box.py:525-539), axis 0 in global coordinates.  A transition
// counts in every constraint it violates (reference sink semantics,
// FspMatrixConstrained.cpp:173-195).
//
// Propensities.  The port cannot trace the Python propensity into CUDA,
// so the caller hands each reaction's a_r as a table along the one axis
// it varies on (a_r(x) = tab_r[x_d], checked bitwise against the torch
// propensity over the whole box; a constant is a table of one entry), or,
// where it depends on two or more axes, as a field row over the window.
// Tables are staged once per block in shared memory.
//
// What bounds it on this card, and what the design does about it.
//   * Work is cut into rows of the last axis.  A warp takes one row at a
//     time, its lanes the last coordinate, so every access to p, dp, the
//     mask, the violation words and the field rows is coalesced, and
//     everything but the last coordinate is uniform along the row: the
//     row's coordinates, its source row pointers and (K3) its intervals
//     are formed once per row by the warp's lanes in parallel and shared
//     through shared memory.  Rows of E <= 16 would leave most lanes idle,
//     so there a warp takes a unit of G = min(32 / E, BOX_GROUP)
//     consecutive rows of one plane, E lanes each (transcr_reg_6d's rows
//     of 13: 26 of 32 lanes busy, not 13).
//   * K3 reads p at valid elements and writes dp: 16 B per element plus
//     the tables, against 64 B when it read the fields.  The segments of
//     32 elements outside the row's valid interval only write zeros; a row
//     with no valid element costs one interval and its zeros.  Where most
//     of the box is valid, the loads per reaction bound it (a table entry
//     and the source's interval from shared memory, p at the source).
//   * K1 reads the mask byte and, at valid elements, p and R violation
//     words: 8 + 1 + 4R bytes plus dp.  It reads the mask bytes of a row's
//     first BOX_PREF segments before the row's set-up, all in flight
//     together, and a row with none valid only writes zeros.  On units
//     of short rows it loads each lane's mask byte a unit ahead.
//   * Sinks: unit u (G rows) adds to partial slot u % BOX_SLOTS, each slot
//     summed by one warp in a fixed order; then the last block to finish
//     (a __threadfence and an atomic ticket on an int counter, which it
//     resets) sums the slots in order, in the same launch, so a matvec
//     reduces its sinks once.
//   * K9.  Its compulsory bytes are nb times a single launch's p and dp,
//     with the tables, K1's mask and violation words read once for the
//     chunk.  A single launch spends most of its time on the per-element
//     work that does not depend on p (shared-memory reads of the tables,
//     the source pointers and intervals, K3's target-interval loop), so
//     the chunk does that work once and only the loads of p, the four
//     operations of each vector's term and its sink adds are repeated.
//     Each vector keeps its accumulator and p(x) in registers; a lane's
//     sink partials for the chunk (NBV x NCM doubles would not fit in
//     registers) live in shared memory in cells only that lane touches,
//     [warp][vector][constraint][lane] (no bank conflicts, no atomics),
//     and are touched only where a transition breaks a constraint.  Each
//     vector's arithmetic is a single launch's, in the same order
//     (elements of a lane in order, reactions in order, constraints in
//     order), its units go to the same slots, each slot is reduced by one
//     warp with the same shuffles, and the last block sums each vector's
//     slots in the single launch's order: dp and the sinks are bitwise nb
//     single launches'.  The launch picks the chunk width (at most NBV)
//     so that the sink cells, the tables and K3's intervals fit the
//     shared memory of BOX_BAT_MIN_BLOCKS resident blocks; wider batches
//     take more chunks (gridDim.y).  Its grid is at most
//     BOX_BAT_MIN_BLOCKS blocks an SM, a single launch's at 4 (which warp
//     takes a slot does not enter the sums).  On an H100, 4 blocks of 64
//     registers ran faster than 3 or 2 (80 or 128 registers) at both
//     shapes timed, and a cp.async copy of the next unit's p rows into
//     shared memory was slower at both (PERF.md, tools/time_k1.py --k9).
//     Tensor cores do not apply: the action is a stencil
//     with per-element coefficients and selections, not a product of
//     tiles, and it is bound by memory latency, not by operations.
//   * K9w.  Its element loop is K9's, and three costs come on top.  A
//     source row in a halo has another vector stride than one in the
//     slab; the part of p a row's source lies in depends only on the
//     reaction, so the row's set-up stores each reaction's stride beside
//     its source pointer and the element loop reads it (no comparisons
//     there).  Over ranks the launch waits for the exchange: a chain of an
//     interior launch under the exchange and an edge launch after it was
//     slower on one card and over 2 NCCL ranks, tied over 4, and K4's one
//     launch beat it over 2 and 4 (PERF.md section 6), so a sharded launch
//     is one launch on the window.  And every launch pays a fixed cost, of
//     which the last block's reduction of nb x nc sums is on the critical
//     path: see "The tail".
//   * The tail (batched launches).  The last block sums each (vector,
//     constraint) pair over part_total partial rows, alone on one SM, so
//     its loads, instructions and barriers are on the critical path.  The
//     partial rows lie pair by pair ([vector][constraint][slot]), so a
//     warp's loads are coalesced, not strided by nc.  Each strided pass
//     over the rows sums BOX_TAIL_ILP pairs in registers, BOX_TAIL_ROWS
//     rows of each loaded together (one load at a time is a round trip to
//     the L2 a row and pair), into per-thread cells [pair][thread] in the
//     sink cells' shared memory (free by then; nbv x nc pairs at a time),
//     then one tree reduces all of them: 9 barriers a chunk of pairs, not
//     9 a pair.  Each pair adds its terms in the single launch's order
//     (thread t: rows t, t + 256, ... in turn; then the same tree), so the
//     sinks stay bitwise nb single launches'.  A single launch keeps its
//     tail of one pair at a time.
//
// Ablation switches.  Two macros, which no production build defines, take
// a piece out of the kernel so that a build without it can be timed
// against the production build (ops/ablation.py, tools/kernel_ablate.py,
// tools/base_probe.py; the counterpart of the reference package's
// tools/kernel_ablate.py and tools/base_probe.py).  A switch build's
// output is not the action: each has a plain version of its own.
//   * BOX_ABLATE_NO_TAIL: the last block resets the ticket and returns
//     without summing the sink slots; the slot partials stay in part.
//   * BOX_ABLATE_ZERO_COORDS: the unit's decode of its rows' in-plane
//     coordinates (the dmul/dshift loop) is left out, and every row takes
//     row 0's (0 on every axis but axis 0, which is the window row, and
//     the last, which is the lane's).  The row's source pointers stay
//     where the row's true index puts them, so p is read at the flat
//     source index, which the caller pads.
//
// Per-call inputs.  The time coefficients c_r(t) and K3's bounds are read
// from device memory (ptr.coef, ptr.bounds; the wrapper's buffer of
// R + nc 8-byte words, rewritten by a stream-ordered copy where they
// change), staged once per block in shared memory; everything else is
// passed by value.  So a launch captured in a CUDA graph (GMRES's Arnoldi
// iteration, ops/gmres.py) runs at the coefficients and bounds the buffer
// holds when the graph replays, not at those of the capture.  Every
// element loop reads c_r from the shared array (one address a warp).
//
// The slots make the sinks independent of the grid, so they are bitwise
// the same in both modes, from run to run and from card to card.  The kernel selects rather
// than multiplies by the mask (an inf or NaN propensity at an invalid
// position never reaches a sum) and uses no float atomics.  It is built with -fmad=false: each
// product and sum is rounded as in the plain PyTorch version, so dp
// matches it bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#define BOX_MAX_R 32
#define BOX_MAX_S 8
#define BOX_MAX_NC 32
#define BOX_THREADS 256
#define BOX_LOG_THREADS 8
#define BOX_WARPS (BOX_THREADS / 32)
static_assert((1 << BOX_LOG_THREADS) == BOX_THREADS,
              "BOX_LOG_THREADS is log2(BOX_THREADS)");
#define BOX_MAX_FNC 16   // constraints a form may describe (K3)
#define BOX_MAX_PROD 2   // product terms of one constraint's form
#define BOX_MAX_N 0x7fffffffLL   // box elements: indices fit 31 bits
#define BOX_CONST_AXIS BOX_MAX_S // table axis of a constant propensity
#define BOX_FIELD_ROW (-1)       // table axis of a propensity read as a row

// Least resident blocks per SM the kernel is compiled for: 64 registers
// a thread.  On the H100 K3 with 3 blocks (80 registers, fewer spills)
// was slower at both shapes timed (PERF.md, Findings).  The wrapper's grid
// is 4 blocks on each of the H100's 132 SMs.
#define BOX_MIN_BLOCKS 4
// K9: most vectors a warp takes a unit for (a chunk), and the least
// resident blocks per SM it is compiled and sized for: its grid is at
// most that many blocks on each SM, and the chunk width keeps its shared
// memory within their share.
#define BOX_BAT_NBV 4
#define BOX_BAT_MIN_BLOCKS 4
// Sink partial slots: unit u adds to slot u % BOX_SLOTS, and slots are
// summed in order, so the sinks do not depend on the grid.
#define BOX_SLOTS 4224
// K1: segments of a row whose mask bytes are read before the row's set-up
#define BOX_PREF 8
// Most rows of the last axis a warp takes at a time where they are short:
// G = min(32 / E, BOX_GROUP) rows of E <= 16 elements, a lane each
#define BOX_GROUP 4
// The batched tail: (vector, constraint) pairs a pass over the partial
// rows sums, and rows a step of it loads, each thread: 16 loads in flight
#define BOX_TAIL_ILP 4
#define BOX_TAIL_ROWS 4
// Reactions interleaved in the element loop: K1, K3 (the best of 1, 2
// and 4 on the H100)
#define BOX_UNROLL_R 1
#define BOX_SYNTH_UNROLL_R 2
// Ends of an unbounded interval of last coordinates
#define BOX_NEG (-(1 << 30))
#define BOX_POS (1 << 30)

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
    long long kflat[BOX_MAX_R];        // flat source offset sum_d s_rd * stride_d
    long long shape[BOX_MAX_S];        // window extents (axis 0: rows)
    int stoich[BOX_MAX_R][BOX_MAX_S];  // s_rd
    long long n;                       // prod(shape)
    int R;
    int S;                             // axes (at least 2; the wrapper pads)
    int nc;
    BoxForm form[BOX_MAX_FNC];         // K3: the constraint forms
    // x / shape[d] = (x * dmul[d]) >> dshift[d] for 0 <= x < 2^31, with
    // dmul = ceil(2^dshift / shape[d]) and dshift = 31 + ceil(log2 shape[d])
    unsigned long long dmul[BOX_MAX_S];
    int dshift[BOX_MAX_S];
    // The window: global row of window row 0, global axis-0 extent,
    // output rows [out_lo, out_hi), elements per plane, and the row
    // strides of the field rows and the violation words.
    long long origin0;
    long long g0;
    long long out_lo;
    long long out_hi;
    long long plane;
    long long rstride;
    long long vstride;
    // p's three parts: window rows [0, up_rows) in p_up, the next mid_rows
    // in p, the rest in p_dn
    long long up_rows;
    long long mid_rows;
    // Propensities: per reaction its table axis (BOX_FIELD_ROW: a field
    // row; BOX_CONST_AXIS: one entry), its offset in the packed tables or
    // its row of the fields, and s_r at the table axis.
    int tab_axis[BOX_MAX_R];
    int tab_off[BOX_MAX_R];
    int tab_shift[BOX_MAX_R];
    int ntab;                          // table entries
    int tab_smem;                      // 1: stage the tables in shared memory
    // K3: the constraints reaction r can break at its source x - s_r and
    // at its target x + s_r where every constraint holds at x, and the
    // number of such (c, r) pairs of both kinds
    unsigned src_mask[BOX_MAX_R];
    unsigned tgt_mask[BOX_MAX_R];
    int ntask;
    int part_total;                    // partial rows the last block sums
    int ticket_total;                  // blocks of the launch
    int group;                         // rows a warp takes at a time (G)
    // Batched mode (K9): vectors of one launch, and the elements between
    // consecutive vectors of p and of dp; the launch sets the chunk width
    // (vectors a block takes, chunk blockIdx.y) and ignores the caller's
    int nb;
    long long p_bstride;
    long long dp_bstride;
    int nbv;
    // K9w: the elements between consecutive vectors of p_up and of p_dn
    long long up_bstride;
    long long dn_bstride;
};

// Device pointers of one launch (mirrored in ops/box_kernel.py).  In the
// batched mode p, dp, part and sinks hold nb vectors: vector v's at
// v * p_bstride, v * dp_bstride, v * part_total * nc and v * nc (and on a
// window p_up's and p_dn's at v * up_bstride and v * dn_bstride); a
// single launch's part holds [slot][constraint], a batched launch's
// [vector][constraint][slot], which its tail reads coalesced.
struct BoxPtrs {
    const double* p_up;
    const double* p;
    const double* p_dn;
    const uint8_t* mask;      // K1: [n] validity
    const double* tab;        // packed tables
    const double* fields;     // field rows, rstride apart
    const int32_t* viol;      // K1: [R] rows of violation words, vstride apart
    double* dp;               // (out_hi - out_lo) * plane outputs
    double* part;             // part_total * nc sink partials
    double* sinks;            // nc sinks
    unsigned* ticket;         // blocks done; reset to 0 by the last
    const double* coef;       // [R] time coefficients c_r(t)
    const long long* bounds;  // K3: [nc] the epoch's constraint bounds
};

// floor(a / b) and the least int at or above it, for b > 0, clamped to
// [BOX_NEG, BOX_POS]
__device__ __forceinline__ int clamp_coord(long long v)
{
    return (int)(v < BOX_NEG ? BOX_NEG : v > BOX_POS ? BOX_POS : v);
}

__device__ __forceinline__ long long floor_div(long long a, long long b)
{
    const long long q = a / b;
    return (a % b != 0 && a < 0) ? q - 1 : q;
}

// The interval [lo, hi] of last coordinates y at which constraint f is
// violated (f > b) on the row whose other coordinates are
// crd[d] + sg * s[d]; empty where lo > hi.  On that row f is A + B y: the
// gate, if any, lies on another axis and no product has both factors on
// the last one.
template <typename F>
__device__ __forceinline__ void violated_on_row(const BoxForm& f,
                                                long long b, const int* crd,
                                                const int* s, int sg,
                                                int last, int& lo, int& hi)
{
    F A = 0, B = (F)f.w[last];
#pragma unroll
    for (int d = 0; d < BOX_MAX_S; ++d)
        if (d < last && f.w[d] != 0)
            A += (F)f.w[d] * (F)(crd[d] + sg * s[d]);
#pragma unroll
    for (int k = 0; k < BOX_MAX_PROD; ++k) {
        if (f.pu[k] == 0) continue;
        const int i0 = f.pi[k], j0 = f.pj[k];
        const F yi = (F)(crd[i0] + sg * s[i0]);
        const F yj = (F)(crd[j0] + sg * s[j0]);
        if (i0 == last) B += (F)f.pu[k] * yj;
        else if (j0 == last) B += (F)f.pu[k] * yi;
        else A += (F)f.pu[k] * yi * yj;
    }
    if (f.gate >= 0 && crd[f.gate] + sg * s[f.gate] != f.gate_val) {
        A = 0;
        B = 0;
    }
    // A + B y > b
    const long long a = (long long)A, bb = (long long)B;
    if (bb == 0) {
        lo = a > b ? BOX_NEG : 1;
        hi = a > b ? BOX_POS : 0;
    } else if (bb > 0) {
        lo = clamp_coord(floor_div(b - a, bb) + 1);
        hi = BOX_POS;
    } else {
        lo = BOX_NEG;
        hi = clamp_coord(-floor_div(b - a, -bb) - 1);
    }
}

// NCM: a compile-time bound on the constraint count; SYNTH: the mode; F:
// the type the synthesized-mask mode evaluates the forms in; GRP: units of
// prm.group short rows (else of one row); NBV: 1 for a single launch, else
// the batched launch (K9) on chunks of at most NBV vectors, an
// instantiation of its own so that a single launch computes no batch
// offsets (they cost K1 and K3 about 3% at the repressilator's final
// capacity on an H100 80GB HBM3 at 700 W, PERF.md); WIN: K9 on a window
// whose halos hold vectors of their own strides (K9w).
template <int NCM, bool SYNTH, typename F, bool GRP, int NBV, bool WIN>
__global__ void __launch_bounds__(BOX_THREADS, NBV > 1 ? BOX_BAT_MIN_BLOCKS
                                                       : BOX_MIN_BLOCKS)
box_action_kernel(const __grid_constant__ BoxParams prm, const BoxPtrs ptr)
{
    constexpr bool BAT = NBV > 1;
    constexpr int NT = SYNTH ? NCM : 1;
    constexpr int NK = SYNTH ? 2 * BOX_MAX_FNC * BOX_MAX_R : 1;
    constexpr int UNROLL_R = SYNTH ? BOX_SYNTH_UNROLL_R : BOX_UNROLL_R;
    // Per block: the moves, the in-plane part of kflat, K3: the forms and
    // the (c, r) pairs whose interval each row needs, source pairs of r
    // from t_first[0][r], target pairs from t_first[1][r], in order of c.
    __shared__ int t_st[BOX_MAX_R][BOX_MAX_S];
    __shared__ long long t_kin[BOX_MAX_R];
    __shared__ BoxForm t_form[NT];
    __shared__ short t_task[NK];
    __shared__ short t_first[2][BOX_MAX_R];
    // the per-call inputs: c_r(t), K3's bounds
    __shared__ double t_c[BOX_MAX_R];
    __shared__ long long t_bnd[SYNTH ? BOX_MAX_FNC : 1];
    // Per warp, for each row of its current unit: the coordinates (last
    // axis 0, and a 0 at BOX_CONST_AXIS), each reaction's source row in p
    // at the row's start (null where the source leaves the box along
    // another axis); K3: each reaction's interval of x whose source is
    // valid.
    constexpr int NG = GRP ? BOX_GROUP : 1;
    __shared__ int w_crd[BOX_WARPS][NG][BOX_MAX_S + 1];
    __shared__ const double* w_src[BOX_WARPS][NG][BOX_MAX_R];
    __shared__ int2 w_sint[BOX_WARPS][SYNTH ? NG : 1][SYNTH ? BOX_MAX_R : 1];
    // K9w: each reaction's vector stride in the part of p its source row
    // lies in (the unit's rows share a plane, so one per unit)
    __shared__ long long w_sbs[WIN ? BOX_WARPS : 1][WIN ? BOX_MAX_R : 1];
    // the last block's reduction (K9: in the sink cells, free by then)
    __shared__ double red_s[BAT ? 1 : BOX_THREADS];
    __shared__ int s_last;
    // Dynamic: the tables (where staged), then K3's pair intervals per
    // warp and row of its unit, then (K9) the sink cells of each warp.
    extern __shared__ double dyn[];

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int R = prm.R, S = prm.S, nc = prm.nc, last = S - 1;
    // K9: the chunk's first vector and its number of vectors (a single
    // launch: vector 0 alone)
    const long long bat = BAT ? (long long)blockIdx.y * prm.nbv : 0;
    const int nv = BAT ? min(prm.nbv, prm.nb - (int)bat) : 1;
    const long long pbs = prm.p_bstride, dbs = prm.dp_bstride;

    const double* tab = ptr.tab;
    if (prm.tab_smem) {
        for (int i = threadIdx.x; i < prm.ntab; i += BOX_THREADS)
            dyn[i] = ptr.tab[i];
        tab = dyn;
    }
    const int ntask_w = SYNTH ? (GRP ? prm.group : 1) * prm.ntask : 0;
    double* dyn_int = dyn + (prm.tab_smem ? prm.ntab : 0);
    int2* w_int = reinterpret_cast<int2*>(dyn_int) + warp * ntask_w;
    // K9: this lane's sink partial of vector v, constraint c at
    // w_sk[(v * nc + c) * 32]; red: the last block's reduction
    double* const sk_base = dyn_int + BOX_WARPS * ntask_w;
    double* const w_sk = sk_base + warp * prm.nbv * nc * 32 + lane;
    double* const red = BAT ? sk_base : red_s;
    for (int i = threadIdx.x; i < BOX_MAX_R * BOX_MAX_S; i += BOX_THREADS) {
        const int r = i / BOX_MAX_S, d = i - r * BOX_MAX_S;
        t_st[r][d] = (r < R && d < S) ? prm.stoich[r][d] : 0;
    }
    if (threadIdx.x < BOX_MAX_R) {
        const int r = threadIdx.x;
        t_kin[r] = r < R ? prm.kflat[r] - (long long)prm.stoich[r][0]
                           * prm.plane : 0;
        t_c[r] = r < R ? ptr.coef[r] : 0.0;
    }
    if constexpr (SYNTH) {
        if (threadIdx.x < NT) t_form[threadIdx.x] = prm.form[threadIdx.x];
        if ((int)threadIdx.x < nc) t_bnd[threadIdx.x] = ptr.bounds[threadIdx.x];
        if (threadIdx.x == 0) {
            int k = 0;
            for (int kind = 0; kind < 2; ++kind) {
                for (int r = 0; r < R; ++r) {
                    t_first[kind][r] = (short)k;
                    const unsigned m = kind ? prm.tgt_mask[r]
                                            : prm.src_mask[r];
                    for (int c = 0; c < nc; ++c)
                        if ((m >> c) & 1u)
                            t_task[k++] = (short)(c | (r << 5)
                                                  | (kind << 10));
                }
            }
        }
    }
    __syncthreads();

    const unsigned E = (unsigned)prm.shape[last];
    const unsigned spr = (E + 31u) / 32u;                 // segments a row
    const unsigned rpp = (unsigned)(prm.plane / E);       // rows a plane
    const int G = GRP ? prm.group : 1;                    // rows a unit
    const unsigned gpp = GRP ? (rpp + G - 1) / G : rpp;   // units a plane
    const unsigned nunits = (unsigned)(prm.out_hi - prm.out_lo) * gpp;
    const unsigned nwarps = gridDim.x * BOX_WARPS;
    const unsigned nslots = nunits < BOX_SLOTS ? nunits : BOX_SLOTS;
    // This lane's row of the unit (sub-row; at or past G: idle) and its
    // first last coordinate.  Without GRP the lane is x.
    const int sub = GRP ? lane / (int)E : 0;
    const int xl0 = lane - sub * (int)E;
    const int subc = sub < G ? sub : 0;                   // for indexing
    // GRP, K1: the mask bit of this lane's element in unit un (rows of
    // E <= 16: one segment), loaded a unit ahead
    auto unit_bit = [&](unsigned un) -> unsigned {
        const unsigned jn = un / gpp;
        const unsigned prn = (un - jn * gpp) * (unsigned)G + (unsigned)sub;
        const long long wn = prm.out_lo + jn;
        return (un < nunits && sub < G && prn < rpp)
            ? (unsigned)(ptr.mask[wn * prm.plane + (long long)prn * E + xl0]
                         != 0) : 0u;
    };

    // Unit u = (output row j, rows [g G, g G + G) of the plane), counted
    // from the first computed row, so a window that is the whole box (or
    // one rank's slab of it) reduces its sinks in one order.  A warp takes
    // slots s, s + nwarps, ...; in each the units s, s + BOX_SLOTS, ...
    for (unsigned s = blockIdx.x * BOX_WARPS + warp; s < nslots;
         s += nwarps) {
        double sk[BAT ? 1 : NCM];
        if constexpr (BAT) {
            for (int i = 0; i < nv * nc; ++i) w_sk[i * 32] = 0.0;
        } else {
#pragma unroll
            for (int c = 0; c < NCM; ++c) sk[c] = 0.0;
        }
        // dp at x of the unit's rows (K9: of each vector of the chunk)
        auto zero_dp = [&](double* row, int x) {
            if constexpr (BAT) {
#pragma unroll
                for (int v = 0; v < NBV; ++v)
                    if (v < nv) row[v * dbs + x] = 0.0;
            } else {
                row[x] = 0.0;
            }
        };
        unsigned vb_next = 0u;
        if constexpr (GRP && !SYNTH) vb_next = unit_bit(s);
        for (unsigned u = s; u < nunits; u += BOX_SLOTS) {
            const unsigned j = u / gpp;
            const unsigned pr0 = (u - j * gpp) * (unsigned)G;
            const unsigned pr = pr0 + (unsigned)sub;      // this lane's row
            const bool rowok = !GRP || (sub < G && pr < rpp);
            const long long wr = prm.out_lo + j;
            int crd[BOX_MAX_S];
            {
#ifdef BOX_ABLATE_ZERO_COORDS
                // Ablation build: no decode; every row takes row 0's
                // in-plane coordinates (see the ablation switches above)
#pragma unroll
                for (int d = 1; d < BOX_MAX_S; ++d) crd[d] = 0;
#else
                unsigned x = rowok ? pr : pr0;
#pragma unroll
                for (int d = BOX_MAX_S - 1; d > 0; --d) {
                    if (d < last) {
                        const unsigned q = (unsigned)(
                            ((unsigned long long)x * prm.dmul[d])
                            >> prm.dshift[d]);
                        crd[d] = (int)(x - q * (unsigned)prm.shape[d]);
                        x = q;
                    } else {
                        crd[d] = 0;
                    }
                }
#endif
                crd[0] = (int)(wr + prm.origin0);
            }
            const long long row_idx = wr * prm.plane + (long long)pr * E;
            const double* p_row = ptr.p + bat * prm.p_bstride
                                  + (wr - prm.up_rows) * prm.plane
                                  + (long long)pr * E;
            double* dp_row = ptr.dp + bat * prm.dp_bstride
                             + (wr - prm.out_lo) * prm.plane
                             + (long long)pr * E;
            __syncwarp();   // the previous unit's shared values are read
            if (xl0 == 0 && sub < G) {
#pragma unroll
                for (int d = 0; d < BOX_MAX_S; ++d)
                    w_crd[warp][sub][d] = crd[d];
                w_crd[warp][sub][BOX_MAX_S] = 0;
            }
            __syncwarp();   // w_crd is written
            // Validity before the rest of the unit's set-up.  K1: one bit
            // per segment from the mask bytes of the first BOX_PREF
            // segments, in flight together (GRP: loaded a unit ahead).  K3:
            // the lane's row's interval [vlo, vhi] of valid x, an
            // intersection over the constraints.
            unsigned vb = 0u;
            int vlo = 0, vhi = -1;
            if constexpr (SYNTH) {
                for (int g = 0; g < G; ++g) {
                    int lo = BOX_NEG, hi = BOX_POS;
                    if (lane < nc) {
                        violated_on_row<F>(t_form[lane], t_bnd[lane],
                                           w_crd[warp][g], t_st[0], 0, last,
                                           lo, hi);
                        // the complement of a violated half-line
                        if (lo > hi) { lo = BOX_NEG; hi = BOX_POS; }
                        else if (lo == BOX_NEG && hi == BOX_POS) { lo = 1; hi = 0; }
                        else if (lo == BOX_NEG) { lo = hi + 1; hi = BOX_POS; }
                        else { hi = lo - 1; lo = BOX_NEG; }
                    }
                    lo = __reduce_max_sync(0xffffffffu, lo);
                    hi = __reduce_min_sync(0xffffffffu, hi);
                    if (g == sub) { vlo = lo; vhi = hi; }
                }
                if (vlo < 0) vlo = 0;
                if (vhi > (int)E - 1) vhi = (int)E - 1;
                if (crd[0] < 0 || crd[0] >= prm.g0 || !rowok) vhi = -1;
            } else if constexpr (GRP) {
                vb = vb_next;
                vb_next = unit_bit(u + BOX_SLOTS);
            } else {
#pragma unroll
                for (int s2 = 0; s2 < BOX_PREF; ++s2) {
                    const unsigned x = s2 * 32u + lane;
                    if (x < E)
                        vb |= (unsigned)(ptr.mask[row_idx + x] != 0) << s2;
                }
            }
            if (SYNTH ? __ballot_sync(0xffffffffu, vlo <= vhi) == 0u
                      : (__ballot_sync(0xffffffffu, vb) == 0u
                         && spr <= BOX_PREF)) {
                // no valid element in the unit's rows
                if (rowok)
                    for (int x = xl0; x < (int)E; x += 32) zero_dp(dp_row, x);
                continue;
            }
            // each (row, reaction) of the unit: the source row's start in
            // p, null where the source leaves the box along another axis
            for (int k = lane; k < R * G; k += 32) {
                const int g = GRP ? k / R : 0, r = k - g * R;
                const int* cg = w_crd[warp][g];
                bool ok = pr0 + g < rpp;
#pragma unroll
                for (int d = 0; d < BOX_MAX_S; ++d) {
                    if (d < last) {
                        const int y = cg[d] - t_st[r][d];
                        const long long hb = d == 0 ? prm.g0 : prm.shape[d];
                        ok = ok && y >= 0 && y < hb;
                    }
                }
                const long long srow = wr - t_st[r][0];
                const double* base =
                    srow < prm.up_rows
                        ? ptr.p_up + (WIN ? bat * prm.up_bstride : 0)
                          + srow * prm.plane
                    : srow < prm.up_rows + prm.mid_rows
                        ? ptr.p + bat * prm.p_bstride
                          + (srow - prm.up_rows) * prm.plane
                        : ptr.p_dn + (WIN ? bat * prm.dn_bstride : 0)
                          + (srow - prm.up_rows - prm.mid_rows)
                          * prm.plane;
                w_src[warp][g][r] =
                    ok ? base + (long long)(pr0 + g) * E - t_kin[r] : nullptr;
                if constexpr (WIN) {
                    if (g == 0)
                        w_sbs[warp][r] = srow < prm.up_rows ? prm.up_bstride
                            : srow < prm.up_rows + prm.mid_rows ? pbs
                            : prm.dn_bstride;
                }
            }
            if constexpr (SYNTH) {
                // the pairs' intervals of each row: where the source
                // x - s_r (kind 0) or the target x + s_r (kind 1) violates
                // c, in x
                for (int k = lane; k < prm.ntask * G; k += 32) {
                    const int g = GRP ? k / prm.ntask : 0;
                    const int tk = t_task[k - g * prm.ntask];
                    const int c = tk & 31, r = (tk >> 5) & 31, kind = tk >> 10;
                    const int sg = kind ? 1 : -1;
                    int lo, hi;
                    violated_on_row<F>(t_form[c], t_bnd[c],
                                       w_crd[warp][g], t_st[r], sg, last, lo,
                                       hi);
                    const int sl = sg * t_st[r][last];
                    if (lo > BOX_NEG) lo -= sl;
                    if (hi < BOX_POS) hi -= sl;
                    w_int[k] = make_int2(lo, hi);
                }
                __syncwarp();   // the pairs' intervals and sources are written
                for (int k = lane; k < R * G; k += 32) {
                    // the interval of x whose source is valid and in the
                    // box: x - s_last in [0, E), and no constraint that r
                    // can break there violated
                    const int g = GRP ? k / R : 0, r = k - g * R;
                    const int sl = t_st[r][last];
                    int lo = sl, hi = (int)E - 1 + sl;
                    if (w_src[warp][g][r] == nullptr) hi = lo - 1;
                    const int k0 = g * prm.ntask + t_first[0][r];
                    const int nk = __popc(prm.src_mask[r]);
                    for (int k2 = k0; k2 < k0 + nk; ++k2) {
                        const int2 v = w_int[k2];
                        // x outside [v.x, v.y]: a half-line
                        if (v.x > v.y) continue;
                        if (v.x == BOX_NEG && v.y == BOX_POS) { hi = lo - 1; }
                        else if (v.x == BOX_NEG) { lo = max(lo, v.y + 1); }
                        else { hi = min(hi, v.x - 1); }
                    }
                    w_sint[warp][g][r] = make_int2(lo, hi);
                }
            }
            __syncwarp();   // the unit's shared values are written

            unsigned s_lo = 0, s_hi = spr - 1;
            if constexpr (SYNTH) {
                if constexpr (!GRP) {
                    s_lo = (unsigned)vlo >> 5;
                    s_hi = (unsigned)vhi >> 5;
                    // segments outside the valid interval: zeros
                    for (int x = lane; x < (int)(s_lo * 32u); x += 32)
                        zero_dp(dp_row, x);
                    for (int x = (int)((s_hi + 1u) * 32u) + lane;
                         x < (int)E; x += 32)
                        zero_dp(dp_row, x);
                }
            }
            const int* lcrd = w_crd[warp][subc];
            const double* const* lsrc = w_src[warp][subc];
            const int2* lsint = w_sint[warp][SYNTH ? subc : 0];
            const int2* lint = w_int + (SYNTH && GRP ? subc * prm.ntask : 0);
            const long long* lsbs = w_sbs[WIN ? warp : 0];
            for (unsigned sr = s_lo; sr <= s_hi; ++sr) {
                const int xl = (int)(sr * 32u) + xl0;
                const bool live = rowok && (unsigned)xl < E;
                const long long idx = row_idx + xl;
                bool valid;
                if constexpr (SYNTH) {
                    valid = vlo <= xl && xl <= vhi;
                } else {
                    valid = sr < BOX_PREF ? ((vb >> sr) & 1u) != 0
                                          : live && ptr.mask[idx] != 0;
                    if (__ballot_sync(0xffffffffu, valid) == 0u) {
                        if (live) zero_dp(dp_row, xl);
                        continue;
                    }
                }
                // A single launch keeps its own copy of the element body.
                // With one body for both, K1 on rows of 13 ran 3% slower
                // on an H100; with only the part that does not depend on p
                // in one inlined helper, the single instantiations spilled
                // more and K1 there ran 5% slower, K1 and K3 at the
                // repressilator's final capacity 7-8% (PERF.md).
                if constexpr (!BAT) {
                    double acc = 0.0;
                    if (valid) {
                        const double pv = p_row[xl];
#pragma unroll UNROLL_R
                        for (int r = 0; r < R; ++r) {
                            const double cr = t_c[r];
                            const int ax = prm.tab_axis[r];
                            const long long koff = prm.kflat[r];
                            long long ti = 0;
                            double a_x;
                            if (ax == BOX_FIELD_ROW) {
                                a_x = ptr.fields[prm.tab_off[r] * prm.rstride
                                                 + idx];
                            } else {
                                ti = prm.tab_off[r] + (ax == last ? xl
                                                       : lcrd[ax]);
                                a_x = tab[ti];
                            }
                            uint32_t bits = 0u;
                            if constexpr (!SYNTH)
                                bits = (uint32_t)ptr.viol[r * prm.vstride + idx];
                            const double ap = a_x * pv;
                            const double* sp = lsrc[r];
                            // K1: the source lies in the box, and its mask
                            // selects; K3: the source is valid and in the box
                            bool ok;
                            if constexpr (SYNTH) {
                                const int2 si = lsint[r];
                                ok = si.x <= xl && xl <= si.y;
                            } else {
                                ok = sp != nullptr
                                     && (unsigned)(xl - t_st[r][last]) < E;
                            }
                            double p_s = 0.0, a_s = 0.0;
                            bool src_valid = false;
                            if (ok) {
                                p_s = sp[xl];
                                a_s = ax == BOX_FIELD_ROW
                                      ? ptr.fields[prm.tab_off[r] * prm.rstride
                                                   + idx - koff]
                                      : tab[ti - prm.tab_shift[r]];
                                if constexpr (SYNTH) src_valid = true;
                                else src_valid = ptr.mask[idx - koff] != 0;
                            }
                            const double in = src_valid ? a_s * p_s : 0.0;
                            acc += cr * (in - ap);
                            if constexpr (SYNTH) {
                                // targets outside the box are evaluated as
                                // they are
                                unsigned ev = prm.tgt_mask[r];
                                int k = t_first[1][r];
                                while (ev) {
                                    const int c = __ffs(ev) - 1;
                                    ev &= ev - 1u;
                                    const int2 v = lint[k++];
                                    if (v.x <= xl && xl <= v.y) bits |= 1u << c;
                                }
                            }
                            if (bits) {
#pragma unroll
                                for (int c = 0; c < NCM; ++c)
                                    if ((bits >> c) & 1u) sk[c] += cr * ap;
                            }
                        }
                    }
                    if (live) dp_row[xl] = acc;
                } else {
                // K9: each vector of the chunk, its p(x) and its sum
                double acc[NBV], pv[NBV];
#pragma unroll
                for (int v = 0; v < NBV; ++v) acc[v] = 0.0;
                if (valid) {
#pragma unroll
                    for (int v = 0; v < NBV; ++v)
                        if (v < nv) pv[v] = p_row[v * pbs + xl];
#pragma unroll UNROLL_R
                    for (int r = 0; r < R; ++r) {
                        const double cr = t_c[r];
                        const int ax = prm.tab_axis[r];
                        const long long koff = prm.kflat[r];
                        long long ti = 0;
                        double a_x;
                        if (ax == BOX_FIELD_ROW) {
                            a_x = ptr.fields[prm.tab_off[r] * prm.rstride
                                             + idx];
                        } else {
                            ti = prm.tab_off[r] + (ax == last ? xl
                                                   : lcrd[ax]);
                            a_x = tab[ti];
                        }
                        uint32_t bits = 0u;
                        if constexpr (!SYNTH)
                            bits = (uint32_t)ptr.viol[r * prm.vstride + idx];
                        const double* sp = lsrc[r];
                        bool ok;
                        if constexpr (SYNTH) {
                            const int2 si = lsint[r];
                            ok = si.x <= xl && xl <= si.y;
                        } else {
                            ok = sp != nullptr
                                 && (unsigned)(xl - t_st[r][last]) < E;
                        }
                        double a_s = 0.0;
                        bool src_valid = false;
                        if (ok) {
                            a_s = ax == BOX_FIELD_ROW
                                  ? ptr.fields[prm.tab_off[r] * prm.rstride
                                               + idx - koff]
                                  : tab[ti - prm.tab_shift[r]];
                            if constexpr (SYNTH) src_valid = true;
                            else src_valid = ptr.mask[idx - koff] != 0;
                        }
                        // each vector's loads of p at the source, all in
                        // flight together, and its term in a single
                        // launch's arithmetic.  K9w: the vector stride of
                        // the part of p the source row lies in
                        const long long sbs = WIN ? lsbs[r] : pbs;
                        double ap[NBV], p_s[NBV];
#pragma unroll
                        for (int v = 0; v < NBV; ++v)
                            p_s[v] = ok && v < nv ? sp[v * sbs + xl] : 0.0;
#pragma unroll
                        for (int v = 0; v < NBV; ++v) {
                            if (v >= nv) continue;
                            ap[v] = a_x * pv[v];
                            const double in = src_valid ? a_s * p_s[v] : 0.0;
                            acc[v] += cr * (in - ap[v]);
                        }
                        if constexpr (SYNTH) {
                            unsigned ev = prm.tgt_mask[r];
                            int k = t_first[1][r];
                            while (ev) {
                                const int c = __ffs(ev) - 1;
                                ev &= ev - 1u;
                                const int2 v = lint[k++];
                                if (v.x <= xl && xl <= v.y) bits |= 1u << c;
                            }
                        }
                        // each (vector, constraint) cell adds in reaction
                        // order, as a single launch's register does
                        while (bits) {
                            const int c = __ffs(bits) - 1;
                            bits &= bits - 1u;
#pragma unroll
                            for (int v = 0; v < NBV; ++v)
                                if (v < nv) w_sk[(v * nc + c) * 32] += cr * ap[v];
                        }
                    }
                }
                if (live) {
#pragma unroll
                    for (int v = 0; v < NBV; ++v)
                        if (v < nv) dp_row[v * dbs + xl] = acc[v];
                }
                }
            }
        }
        // the slot's partial: warp shuffles in a fixed order (K9: for
        // each vector of the chunk in turn)
        if constexpr (BAT) {
            for (int v = 0; v < nv; ++v) {
                for (int c = 0; c < nc; ++c) {
                    double t = w_sk[(v * nc + c) * 32];
#pragma unroll
                    for (int o = 16; o > 0; o >>= 1)
                        t += __shfl_down_sync(0xffffffffu, t, o);
                    if (lane == 0)
                        ptr.part[((bat + v) * nc + c) * prm.part_total
                                 + s] = t;
                }
            }
        } else {
#pragma unroll
            for (int c = 0; c < NCM; ++c) {
                if (c < nc) {
                    double v = sk[c];
#pragma unroll
                    for (int o = 16; o > 0; o >>= 1)
                        v += __shfl_down_sync(0xffffffffu, v, o);
                    if (lane == 0)
                        ptr.part[(bat * prm.part_total + s) * nc + c] = v;
                }
            }
        }
    }

    if (nc == 0) return;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
        s_last = atomicAdd(ptr.ticket, 1u)
                 == (unsigned)prm.ticket_total - 1u;
    __syncthreads();
    if (!s_last) return;
#ifdef BOX_ABLATE_NO_TAIL
    // Ablation build: the partial rows stay in part, unsummed
    if (threadIdx.x == 0) *ptr.ticket = 0u;
    return;
#endif
    // The last block: sinks[c] = sum_b part[b, c] over every partial row
    // of the launch, in a fixed order (strided per thread, then a tree).
    __threadfence();
    if constexpr (BAT) {
        // Every (vector, constraint) pair k = v nc + c, whose partial rows
        // lie at part + k part_total (coalesced), nbv nc pairs (the sink
        // cells' room) at a time: thread t's strided sum of pair k into
        // red[k * BOX_THREADS + t], BOX_TAIL_ILP pairs a pass over the
        // rows, BOX_TAIL_ROWS rows of each loaded together, with their
        // sums in registers; then one tree for all.
        const int npair = prm.nb * nc, chunk = prm.nbv * nc;
        const int pt = prm.part_total;
        for (int k0 = 0; k0 < npair; k0 += chunk) {
            const int K = min(chunk, npair - k0);
            for (int k = 0; k < K; k += BOX_TAIL_ILP) {
                const double* const col = ptr.part + (long long)(k0 + k) * pt;
                double sm[BOX_TAIL_ILP];
#pragma unroll
                for (int i = 0; i < BOX_TAIL_ILP; ++i) sm[i] = 0.0;
                int b = threadIdx.x;
                for (; b + (BOX_TAIL_ROWS - 1) * BOX_THREADS < pt;
                     b += BOX_TAIL_ROWS * BOX_THREADS) {
                    double x[BOX_TAIL_ROWS][BOX_TAIL_ILP];
#pragma unroll
                    for (int j = 0; j < BOX_TAIL_ROWS; ++j)
#pragma unroll
                        for (int i = 0; i < BOX_TAIL_ILP; ++i)
                            x[j][i] = k + i < K
                                ? __ldcg(col + (long long)i * pt + b
                                         + j * BOX_THREADS) : 0.0;
                    // each pair's rows in order
#pragma unroll
                    for (int j = 0; j < BOX_TAIL_ROWS; ++j)
#pragma unroll
                        for (int i = 0; i < BOX_TAIL_ILP; ++i)
                            sm[i] += x[j][i];
                }
                for (; b < pt; b += BOX_THREADS) {
#pragma unroll
                    for (int i = 0; i < BOX_TAIL_ILP; ++i)
                        if (k + i < K)
                            sm[i] += __ldcg(col + (long long)i * pt + b);
                }
#pragma unroll
                for (int i = 0; i < BOX_TAIL_ILP; ++i)
                    if (k + i < K) red[(k + i) * BOX_THREADS + threadIdx.x]
                                       = sm[i];
            }
            __syncthreads();
            for (int lw = BOX_LOG_THREADS - 1; lw >= 0; --lw) {
                const int w = 1 << lw;
                for (int i = threadIdx.x; i < K << lw; i += BOX_THREADS) {
                    const int at = (i >> lw) * BOX_THREADS + (i & (w - 1));
                    red[at] += red[at + w];
                }
                __syncthreads();
            }
            for (int k = threadIdx.x; k < K; k += BOX_THREADS)
                ptr.sinks[k0 + k] = red[k * BOX_THREADS];
            __syncthreads();
        }
    } else {
        for (int c = 0; c < nc; ++c) {
            double sm = 0.0;
            for (int b = threadIdx.x; b < prm.part_total; b += BOX_THREADS)
                sm += __ldcg(ptr.part + (long long)b * nc + c);
            red[threadIdx.x] = sm;
            __syncthreads();
            for (int w = BOX_THREADS / 2; w > 0; w >>= 1) {
                if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
                __syncthreads();
            }
            if (threadIdx.x == 0) ptr.sinks[c] = red[0];
            __syncthreads();
        }
    }
    if (threadIdx.x == 0) *ptr.ticket = 0u;
}

extern "C" int box_action_threads(void) { return BOX_THREADS; }

extern "C" int box_action_params_size(void) { return (int)sizeof(BoxParams); }

extern "C" int box_action_ptrs_size(void) { return (int)sizeof(BoxPtrs); }

extern "C" int box_action_max_form_constraints(void) { return BOX_MAX_FNC; }

// The window's fields describe computed rows of a box of fewer than 2^31
// elements inside the global box and inside p's middle part, whose global
// axis-0 coordinates fit an int (the wrapper checks more: that every
// source a computed row reads lies in the window and in a part of p it
// was given).
static bool window_ok(const BoxParams* prm, int nblocks)
{
    if (prm->R < 0 || prm->R > BOX_MAX_R || prm->S < 2
            || prm->S > BOX_MAX_S || prm->nc < 0 || prm->nc > BOX_MAX_NC)
        return false;
    const long long E = prm->shape[prm->S - 1];
    bool ok = prm->n <= BOX_MAX_N && prm->plane >= 1 && E >= 1
        && prm->plane % E == 0
        && prm->shape[0] * prm->plane == prm->n
        && 0 <= prm->out_lo && prm->out_lo <= prm->out_hi
        && prm->out_hi <= prm->shape[0]
        && prm->up_rows <= prm->out_lo
        && prm->out_hi <= prm->up_rows + prm->mid_rows
        && prm->rstride >= prm->n && prm->vstride >= prm->n
        && prm->g0 >= 1 && prm->g0 <= BOX_MAX_N
        && prm->origin0 > -BOX_MAX_N && prm->origin0 < BOX_MAX_N
        && prm->origin0 + prm->out_lo >= 0
        && prm->origin0 + prm->out_hi <= prm->g0
        && prm->group >= 1 && prm->group <= BOX_GROUP
        && (prm->group == 1 || prm->group * E <= 32)
        && prm->ntab >= 0 && nblocks >= 1
        && prm->nb >= 1 && prm->nb <= 65535
        && (prm->nb == 1 || (prm->p_bstride >= prm->mid_rows * prm->plane
                             && prm->dp_bstride >= (prm->out_hi - prm->out_lo)
                                                   * prm->plane
                             && prm->up_bstride >= prm->up_rows * prm->plane
                             && prm->dn_bstride
                                >= (prm->shape[0] - prm->up_rows
                                    - prm->mid_rows) * prm->plane))
        && nblocks <= prm->ticket_total;
    for (int r = 0; ok && r < prm->R; ++r) {
        const int ax = prm->tab_axis[r];
        ok = ax == BOX_FIELD_ROW || ax == BOX_CONST_AXIS
             || (ax >= 0 && ax < prm->S);
    }
    return ok;
}

// One launch of an instantiation on ``st``, or with ptr == nullptr only
// the grid it would take.  Where ``grid`` is given it receives the grid's
// x and y extents, the chunk width and the most blocks a batched launch
// takes along x (a single launch: nblocks, 1, 1, nblocks).
template <int NCM, bool SYNTH, typename F, bool GRP, int NBV, bool WIN>
static cudaError_t launch_kernel(const BoxParams* prm, const BoxPtrs* ptr,
                                 int nblocks, cudaStream_t st, int* grid)
{
    auto kern = box_action_kernel<NCM, SYNTH, F, GRP, NBV, WIN>;
    // Dynamic shared memory beyond 48 KB must be asked for, once per
    // kernel: all that the card lets a block have beside the static part.
    // K9 also sizes its chunk by the share of an SM's shared memory that
    // each of BOX_BAT_MIN_BLOCKS resident blocks may have, and its grid by
    // the SMs.
    static int max_dyn = -1, share = 0, sms = 0;
    if (max_dyn < 0) {
        cudaFuncAttributes fa;
        cudaError_t e = cudaFuncGetAttributes(&fa, kern);
        if (e != cudaSuccess) return e;
        int dev = 0, optin = 0, per_sm = 0, reserved = 0;
        e = cudaGetDevice(&dev);
        if (e != cudaSuccess) return e;
        e = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (e == cudaSuccess)
            e = cudaDeviceGetAttribute(
                &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
        if (e == cudaSuccess)
            e = cudaDeviceGetAttribute(
                &reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
        if (e == cudaSuccess)
            e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev);
        if (e != cudaSuccess) return e;
        const int most = optin - (int)fa.sharedSizeBytes;
        e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
        if (e != cudaSuccess) return e;
        share = per_sm / BOX_BAT_MIN_BLOCKS - reserved
                - (int)fa.sharedSizeBytes;
        max_dyn = most;
    }
    const size_t base = (prm->tab_smem ? (size_t)prm->ntab * sizeof(double)
                                       : 0)
        + (SYNTH ? (size_t)BOX_WARPS * prm->group * prm->ntask
                     * sizeof(int2) : 0);
    if constexpr (NBV == 1) {
        if (base > (size_t)max_dyn) return cudaErrorInvalidValue;
        if (grid) {
            grid[0] = nblocks; grid[1] = 1; grid[2] = 1; grid[3] = nblocks;
        }
        if (!ptr) return cudaSuccess;
        kern<<<nblocks, BOX_THREADS, base, st>>>(*prm, *ptr);
    } else {
        // the widest chunk whose sink cells fit the share (at least one
        // vector, within what a block may have)
        const size_t per_vec = (size_t)BOX_WARPS * 32 * prm->nc
                               * sizeof(double);
        int nbv = prm->nb < NBV ? prm->nb : NBV;
        while (nbv > 1 && base + nbv * per_vec > (size_t)(share > 0 ? share
                                                                    : 0))
            --nbv;
        const size_t dyn = base + nbv * per_vec;
        if (dyn > (size_t)max_dyn) return cudaErrorInvalidValue;
        const int most_blocks = BOX_BAT_MIN_BLOCKS * sms;
        const int gx = nblocks < most_blocks ? nblocks : most_blocks;
        const int gy = (prm->nb + nbv - 1) / nbv;
        if (grid) {
            grid[0] = gx; grid[1] = gy; grid[2] = nbv; grid[3] = most_blocks;
        }
        if (!ptr) return cudaSuccess;
        // the ticket counts this grid's blocks (the caller's ticket_total)
        if ((long long)gx * gy > prm->ticket_total)
            return cudaErrorInvalidValue;
        BoxParams q = *prm;
        q.nbv = nbv;
        kern<<<dim3(gx, gy), BOX_THREADS, dyn, st>>>(q, *ptr);
    }
    return cudaGetLastError();
}

template <int NCM, bool SYNTH, typename F, bool GRP>
static cudaError_t launch_rows(const BoxParams* prm, const BoxPtrs* ptr,
                               int nblocks, cudaStream_t st, int* grid)
{
    if (prm->nb == 1)
        return launch_kernel<NCM, SYNTH, F, GRP, 1, false>(prm, ptr, nblocks,
                                                           st, grid);
    // K9 on a whole box, or on a window with halos (K9w)
    return prm->up_rows == 0 && prm->mid_rows == prm->shape[0]
        ? launch_kernel<NCM, SYNTH, F, GRP, BOX_BAT_NBV, false>(
              prm, ptr, nblocks, st, grid)
        : launch_kernel<NCM, SYNTH, F, GRP, BOX_BAT_NBV, true>(
              prm, ptr, nblocks, st, grid);
}

template <int NCM, bool SYNTH, typename F>
static cudaError_t launch(const BoxParams* prm, const BoxPtrs* ptr,
                          int nblocks, cudaStream_t st, int* grid)
{
    return prm->group > 1
        ? launch_rows<NCM, SYNTH, F, true>(prm, ptr, nblocks, st, grid)
        : launch_rows<NCM, SYNTH, F, false>(prm, ptr, nblocks, st, grid);
}

static int dispatch(const BoxParams* prm, const BoxPtrs* ptr, int nblocks,
                    int synth, int narrow, int device, void* stream,
                    int* grid)
{
    if (!window_ok(prm, nblocks)
            || (synth && (prm->nc > BOX_MAX_FNC || prm->ntask < 0
                          || prm->ntask > 2 * BOX_MAX_FNC * BOX_MAX_R)))
        return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    cudaStream_t st = (cudaStream_t)stream;
    if (!synth)
        e = prm->nc <= 8
            ? launch<8, false, long long>(prm, ptr, nblocks, st, grid)
            : launch<BOX_MAX_NC, false, long long>(prm, ptr, nblocks, st,
                                                   grid);
    else if (prm->nc <= 8)
        e = narrow ? launch<8, true, int>(prm, ptr, nblocks, st, grid)
            : launch<8, true, long long>(prm, ptr, nblocks, st, grid);
    else
        e = narrow ? launch<BOX_MAX_FNC, true, int>(prm, ptr, nblocks, st,
                                                     grid)
            : launch<BOX_MAX_FNC, true, long long>(prm, ptr, nblocks, st,
                                                    grid);
    return (int)e;
}

// Launches the box kernel on ``stream`` of CUDA device ``device``: the
// mask-reading mode (synth = 0: K1, or K4 on a window; with prm->nb > 1
// K9, or K9w on a window) or the
// synthesized-mask mode (synth = 1: K3, or K4 on a window; ptr->bounds
// and prm->form describe the constraints; narrow = 1 evaluates the forms
// in int32, which the caller allows only where no value at any box point
// or its neighbours can overflow it, so the result is the int64
// evaluation's).  Returns cudaGetLastError() of the launch (0 =
// cudaSuccess).
extern "C" int box_action_launch(const BoxParams* prm, const BoxPtrs* ptr,
                                 int nblocks, int synth, int narrow,
                                 int device, void* stream)
{
    return dispatch(prm, ptr, nblocks, synth, narrow, device, stream,
                    nullptr);
}

// The grid box_action_launch would take with the same arguments, into
// grid[0..3]: blocks along x, chunks along y, the chunk width and the most
// blocks along x; launches nothing.  A batched launch's ticket_total is
// grid[0] * grid[1].
extern "C" int box_action_grid(const BoxParams* prm, int nblocks, int synth,
                               int narrow, int device, int* grid)
{
    return dispatch(prm, nullptr, nblocks, synth, narrow, device, nullptr,
                    grid);
}
