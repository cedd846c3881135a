// Device event extraction for the shift-XOR scan, written for Hopper (sm_90a).
//
// Two kernels replace the two Pallas passes of
// ribbit_tpu/scan_events_pallas.py.  Both compute, per shift row r
// (shift s = min_shift + r, r < ns), the match bitmap
//
//     eq[r][p] = code[p] == code[p + s]      for 0 <= p < L,
//
// where code reads as 0 past L (the reference's zero-fill tail, and N
// bases encode as 0 too).  Positions p < 0 never match.
//
// anchor_planes_kernel (replaces _anchor_kernel, scan_events_pallas.py:95)
//   An anchor is a maximal run of eq restricted to p < L - s whose length
//   lies in [3, 2s) and which closes strictly before L - s
//   (parse_anchored_shiftxor.cpp:20-56).  Output: one bit-word per 32
//   positions per shift row, [ns, ceil(L/32)] (4 B per 32 bp per row,
//   13 B/bp at the default config).  The planes never leave the device.
//
// event_words_kernel (replaces _kernel, scan_events_pallas.py:187)
//   For the 8 rows of one output plane: the overlay ov = eq | anchors of
//   rows r-2, r-1, r+1, r+2 (those in [0, ns)), and three bitmaps
//     q6 = popcount(ov[p..p+7]) >= 6 and no N in n_mask[p..p+7]
//     q7 = popcount(eq[p..p+7]) >= 7 and no N in n_mask[p..p+7]
//     pm = eq[p] and not N[p]
//   where positions >= L count as N.  Output word layout (fixed; read by
//   csrc/ribbit_events.c): bits 0-7 q6, 8-15 q7, 16-23 pm, one int32 per
//   position per plane, [ngroups, L].
//
// dense_masks_kernel (replaces _kernel, scan_pallas_v4.py:70, and
//   _gen_kernel_body, scan_pallas_full.py:78, which compute the same planes)
//   For motif rows k (shift row r = r0 + k, shift = motif m = min_shift + r)
//   four int8 planes [nm, L]: q7 and q6 as above, pm = eq & ~N, and
//     ps[p] = pm[p] & ~pm[p-1] & (the pm run from p is >= cutoff),
//   cutoff = 12 - m if m <= 6 else m, pm[-1] = 0.  The run length is exact
//   (the Pallas kernels saturate it at 128 and 256; every cutoff up to 128
//   gives the same planes).  Output: [4][nm][L], planes q7, q6, ps, pm.
//
// What bounds them on this card: the event pass writes 52 B/bp (13 planes
// x 4 B) and that plane then crosses PCIe to the host, so the output bytes
// bound the pass (0.167 ms at an 8 Mi-bp segment); compute is about ns x
// (an 8-bit window popcount twice, four neighbour ORs) integer ops per bp.
// The dense pass writes 4 B per motif row per bp (396 B/bp at the default
// config) against 14.75 B/bp read, so it too is bound by its output bytes.
// The anchor pass writes 12.75 B/bp (0.032 ms at the segment), but its
// run test issues over a hundred instructions per word and row, so the
// instruction issue, not its bytes, sets its pace (PERF.md).  Each pass
// keeps every per-position quantity as a bit in a 32-bit word.  The dense
// pass builds eq once per block into shared memory as bit-words (a byte
// loop, eq_word), searches runs with __clz / __ffs over whole words, takes
// an 8-position window as one __funnelshift_r plus __popc and writes four
// positions of a plane per 32-bit store.
//
// The anchor pass takes a tile of 512 words (16,384 positions) of every
// shift row in one block.  The block builds the code's two bit-planes over
// the tile and K + 1 words on each side (K = ceil(2 s_max / 32); 8 words,
// 3% of the tile, at the default config) once by __ballot_sync
// (plane_words, below); a run that reaches K words past a word is at least
// 2s long and never an anchor.  A thread then owns one word of each row,
// row after row with no barrier: the eq word of its word (two funnel
// shifts over the planes, eq_planes, masked before position 0 and from
// L - s on), its neighbours' from the lanes beside it by __shfl_sync
// (lanes 0 and 31 build the word past the warp's edge), the runs through
// bit 0 and bit 31 measured by __clz of the neighbours (walking on, eq word
// by eq word, only past a neighbour of all ones), the runs inside the word
// tested bit-parallel, and consecutive threads store consecutive words of
// a row.
//
// The event pass works on 32 positions at once, so that its integer work
// falls towards its 52 B/bp of stores.  A block builds the code's two
// bit-planes and the N words of its tile once by __ballot_sync (codes are
// 0-3, N reads as 0, so equal codes <=> equal bits in both planes) and
// reuses them for every plane; a thread then takes one word (32 positions)
// of each plane: eq of shift s is ~((lo ^ lo>>s) | (hi ^ hi>>s)), two funnel
// shifts over words; anchors are read by consecutive threads at consecutive
// words; q6 and q7 of 32 windows come from bit-sliced counters of the zeros
// in the 8 shifted copies of the word; one 32 x 32 bit transpose in
// registers turns the 24 bit-rows (q6, q7, pm of 8 rows) into 32 int32, and
// a staging tile in shared memory lets a warp store each word as 128
// contiguous bytes.  On an H100 that reaches about two thirds of the byte
// bound (PERF.md); a warp-wide version (a lane a bit-row, the transpose by
// __shfl_xor_sync) ran half as fast: half its lanes counted no window.

#include <cuda_runtime.h>
#include <stdint.h>

typedef uint32_t u32;

#define THREADS 256    // dense pass: threads a block
#define TW 64          // dense pass: bit-words (of 32 positions) a block tile
#define OUT_ROWS 8     // shift rows per output plane in the event pass

// eq bit-word for word-local offset lb (byte offset of the word's first
// position in the shared code tile), global position p0 of its bit 0 and
// shift s; bits at p < 0 or p >= lim are 0.
__device__ __forceinline__ u32 eq_word(const uint8_t *sc, int lb, int p0,
                                       int s, int lim)
{
    u32 w = 0;
#pragma unroll 8
    for (int j = 0; j < 32; j++) {
        int p = p0 + j;
        if (p >= 0 && p < lim && sc[lb + j] == sc[lb + j + s])
            w |= 1u << j;
    }
    return w;
}

#define EV_T 256       // event pass: threads a block = tile words, one each
#define EV_WARPS (EV_T / 32)
#define EV_PU 4        // words a warp has in flight while building the planes
#define AROWS (OUT_ROWS + 4)   // anchor rows one plane's overlay reads

// The code's two bit-planes and the N words over n words from global word
// w0, into shared memory: bit j of lo[i] / hi[i] is bit 0 / 1 of the code
// at position 32 (w0 + i) + j (0 past L, and before 0 without N words),
// bit j of nw[i] says N there (1 past L).  Codes are 0-3 and N is 0, so two
// positions hold equal codes iff both planes agree there.  Each warp of the
// block takes every nwarps-th word, one position a lane and one
// __ballot_sync per word, PU words in flight; no barrier.  Without N words
// (WITH_N false) nmask and nw are not touched and w0 may be negative.
template <bool WITH_N, int PU>
__device__ __forceinline__ void plane_words(const uint8_t *__restrict__ code,
                                            const uint8_t *__restrict__ nmask,
                                            int L, int w0, int n, u32 *lo,
                                            u32 *hi, u32 *nw)
{
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    for (int i4 = warp; i4 < n; i4 += PU * nwarps) {
        u32 c[PU];
        bool nb[PU];
#pragma unroll
        for (int u = 0; u < PU; u++) {
            int i = i4 + u * nwarps;
            long long p = (long long)(w0 + i) * 32 + lane;
            bool in = i < n && p < L && (WITH_N || p >= 0);
            c[u] = in ? code[p] : 0u;
            nb[u] = WITH_N && (!in || nmask[p] != 0);
        }
#pragma unroll
        for (int u = 0; u < PU; u++) {
            int i = i4 + u * nwarps;
            u32 b0 = __ballot_sync(0xffffffffu, c[u] & 1u);
            u32 b1 = __ballot_sync(0xffffffffu, c[u] & 2u);
            u32 bn = __ballot_sync(0xffffffffu, nb[u]);
            if (lane == 0 && i < n) {
                lo[i] = b0;
                hi[i] = b1;
                if (WITH_N)
                    nw[i] = bn;
            }
        }
    }
}

// eq bit-word of shift s = 32 q + b at a word whose planes are l and h: la,
// lb (ha, hb) are the planes of words q and q + 1 further on.  Bit j is set
// iff the codes at p and p + s are equal, p the position of bit j.
__device__ __forceinline__ u32 eq_planes(u32 l, u32 h, u32 la, u32 lb,
                                         u32 ha, u32 hb, int b)
{
    return ~((l ^ __funnelshift_r(la, lb, b))
             | (h ^ __funnelshift_r(ha, hb, b)));
}

#define AT 512         // anchor pass: threads a block = tile words, one each
#define APU 16         // anchor pass: code words a warp loads at once

// eq word of shift s = 32 q + b at plane word j (global word gw), masked:
// 0 before position 0 and from hi = L - s on (whi = hi >> 5; hmask, the
// bits of word whi below hi).
__device__ __forceinline__ u32 eq_at(const u32 *lo, const u32 *hi, int j,
                                     int q, int b, int gw, int whi,
                                     u32 hmask)
{
    u32 v = eq_planes(lo[j], hi[j], lo[j + q], lo[j + q + 1], hi[j + q],
                      hi[j + q + 1], b);
    return gw < 0 || gw > whi ? 0u : gw == whi ? v & hmask : v;
}

// Ones that run on past plane word j + step, a word of all ones, in the
// direction step (-1: down from bit 31 of the word below, +1: up from bit
// 0 of the word above, ...): 32 plus their count, or at least cap once the
// count reaches cap.  Rare: only runs of 32 or more come here.
__device__ __noinline__ int ones_beyond(const u32 *lo, const u32 *hi, int j,
                                        int gw, int step, int s, int whi,
                                        u32 hmask, int cap)
{
    const int q = s >> 5, b = s & 31;
    int n = 32;
    for (int k = 2 * step; n < cap; k += step) {
        const u32 x = ~eq_at(lo, hi, j + k, q, b, gw + k, whi, hmask);
        const int c = step < 0 ? __clz(x) : __clz(__brev(x));
        n += c;
        if (c < 32)
            break;
    }
    return n;
}

// Grid: tiles of AT words (32 positions each); a block writes every shift
// row of its tile, a thread one word of each row, row after row with no
// barrier.  Shared memory: the code's two bit-planes over the tile and H =
// K + 1 words on each side (K = ceil(2 s_max / 32)), and the s_max
// positions eq reads past them, built once.  Per row, a thread builds the
// eq word of its word and one more (lane 0 the word below the warp's 32,
// lane 31 the word above, the others a spare), takes its neighbours' from
// the lanes beside it by __shfl_sync and decides its word's anchors:
//   the runs through bit 0 and bit 31 (tmask, lmask; one run if the word
//   is all ones) take their lengths from the ones that run on into the
//   neighbours (cl, cr), which walk further, eq word by eq word, only past
//   a neighbour of all ones, and never past K words (a run that long is
//   at least 2s and no anchor); the runs inside the word are at most 30
//   long and are tested bit-parallel: t marks 3 ones in a row and is
//   dilated back over them, u marks 2s ones in a row (only s <= 15 can
//   have them) and is dilated over them likewise, by log-doubling shifts.
// Consecutive threads store consecutive words of a row.
__global__ void __launch_bounds__(AT) anchor_planes_kernel(
    const uint8_t *__restrict__ code, int L, int min_shift, int ns, int K,
    u32 *__restrict__ out, int W)
{
    extern __shared__ u32 sw[];
    const int s_max = min_shift + ns - 1, H = K + 1;
    const int NP = AT + 2 * H + (s_max >> 5) + 1;   // plane words
    u32 *lo = sw, *hi = lo + NP;

    const int w0 = blockIdx.x * AT, wb = w0 - H;    // wb: word of lo[0]
    plane_words<false, APU>(code, nullptr, L, wb, NP, lo, hi, nullptr);
    __syncthreads();

    const int i = threadIdx.x, lane = i & 31, w = w0 + i, j = H + i;
    const int jx = lane == 0 ? j - 1 : j + 1;       // the extra word
    const u32 L0 = lo[j], H0 = hi[j], LX = lo[jx], HX = hi[jx];
    u32 *o = out + w;
    for (int row = 0; row < ns; row++, o += W) {
        const int s = min_shift + row, q = s >> 5, b = s & 31, n2 = 2 * s;
        const int hpos = L - s, whi = hpos >> 5;
        const int rem = hpos - 32 * min(w, W);     // w >= W: not stored
        const u32 hmask = (1u << (hpos & 31)) - 1u;
        u32 e = eq_planes(L0, H0, lo[j + q], lo[j + q + 1], hi[j + q],
                          hi[j + q + 1], b);
        u32 x = eq_planes(LX, HX, lo[jx + q], lo[jx + q + 1], hi[jx + q],
                          hi[jx + q + 1], b);
        e = w > whi ? 0u : w == whi ? e & hmask : e;
        const int gx = wb + jx;
        x = gx < 0 || gx > whi ? 0u : gx == whi ? x & hmask : x;
        u32 ep = __shfl_up_sync(0xffffffffu, e, 1);
        u32 en = __shfl_down_sync(0xffffffffu, e, 1);
        ep = lane == 0 ? x : ep;
        en = lane == 31 ? x : en;

        int cl = __clz(~ep);                       // ones below bit 0
        int cr = __clz(__brev(~en));               // ones above bit 31
        if (cl == 32)
            cl = ones_beyond(lo, hi, j, w, -1, s, whi, hmask, n2);
        if (cr == 32)
            cr = ones_beyond(lo, hi, j, w, 1, s, whi, hmask, n2);
        const bool full = e == 0xffffffffu;
        const int tc = __clz(__brev(~e)), lc = __clz(~e);   // 32 if full
        const u32 tmask = full ? 0xffffffffu : (1u << tc) - 1u;
        const u32 lmask = full ? 0xffffffffu : ~(0xffffffffu >> lc);
        const u32 in = e & ~tmask & ~lmask;        // runs closed inside
        const u32 t = in & (in >> 1) & (in >> 2);
        u32 a = t | (t << 1) | (t << 2);
        if (n2 <= 30) {                            // uniform in the block
            u32 u = in;
            int k = 1;
            for (; 2 * k <= n2; k *= 2)
                u &= u >> k;
            u &= u >> (n2 - k);                    // bit j: in[j .. j + 2s)
            for (k = 1; 2 * k <= n2; k *= 2)
                u |= u << k;
            u |= u << (n2 - k);
            a &= ~u;
        }
        if (rem > 0 && rem < 32) {                 // the inner run through
            int c = __clz(~(in << (32 - rem)));    // hi - 1 stays open
            a &= ~(((1u << c) - 1u) << (rem - c));
        }
        const int lenl = cl + tc + (full ? cr : 0), endl = full ? 32 + cr : tc;
        const int lenr = lc + cr + (full ? cl : 0);
        if (tc && lenl >= 3 && lenl < n2 && endl < rem)
            a |= tmask;
        if (lc && lenr >= 3 && lenr < n2 && 32 + cr < rem)
            a |= lmask;
        if (w < W)
            *o = a;
    }
}

// Bit j: at most one (one = ~0) or two (one = 0) zeros among bits j..j+7 of
// the 64-bit x1:x0; bit-sliced counters of the zeros, saturating at three.
__device__ __forceinline__ u32 few_zeros(u32 x0, u32 x1, u32 one)
{
    u32 two = 0, three = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
        u32 z = ~__funnelshift_r(x0, x1, j);
        three |= two & z;
        two |= one & z;
        one |= z;
    }
    return ~three;
}

// In-register 32 x 32 bit transpose: afterwards bit b of A[j] is bit j of
// the old A[b].  Each stage swaps the off-diagonal m x m blocks of every
// 2m x 2m block; rows known to be 0 fold away.
__device__ __forceinline__ void transpose32(u32 (&A)[32])
{
#pragma unroll
    for (int t = 0; t < 5; t++) {
        const int m = 16 >> t;
        const u32 lo = 0xffffffffu / ((1u << m) + 1u);   // 0x0000ffff ...
#pragma unroll
        for (int k = 0; k < 32; k++) {
            if (k & m)
                continue;
            u32 x = ((A[k] >> m) ^ A[k + m]) & lo;
            A[k + m] ^= x;
            A[k] ^= x << m;
        }
    }
}

// Grid: tiles of EV_T words (32 positions each); a block writes every plane
// of its tile, a thread one word of each plane.  Shared memory: the code's
// planes and the N words of the tile and its right halo (built once), then
// a [32][33] staging tile per warp.  Per plane, a thread takes its word w
// and w + 1 (for the 8-windows that start in w): eq of the plane's 8 rows
// from the planes, the overlay with anchor rows g*8 - 2 .. g*8 + 9 (loads
// of consecutive words by consecutive threads), the 24 bit-rows q6, q7, pm,
// one transpose to 32 int32, and through the warp's staging tile 32 stores
// of 128 contiguous bytes.
__global__ void __launch_bounds__(EV_T) event_words_kernel(
    const uint8_t *__restrict__ code, const uint8_t *__restrict__ nmask,
    const u32 *__restrict__ anch, int L, int min_shift, int ns, int ngroups,
    int W, int32_t *__restrict__ out)
{
    extern __shared__ u32 sw[];
    const int s_max = min_shift + ns - 1;
    const int EW = EV_T + (s_max + 31) / 32 + 2;  // the last eq reads word
    u32 *lo = sw, *hi = lo + EW, *nw = hi + EW;   // EV_T + s_max / 32 + 1
    u32 *st = nw + EW;                            // [EV_WARPS][32][33]

    const int w0 = blockIdx.x * EV_T;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    plane_words<true, EV_PU>(code, nmask, L, w0, EW, lo, hi, nw);
    __syncthreads();

    const int i = threadIdx.x, w = w0 + i;
    const u32 L0 = lo[i], L1 = lo[i + 1], H0 = hi[i], H1 = hi[i + 1];
    u32 nany = nw[i];
#pragma unroll
    for (int j = 1; j < 8; j++)
        nany |= __funnelshift_r(nw[i], nw[i + 1], j);
    const u32 nfree = ~nany, notn = ~nw[i];
    u32 *sg = st + warp * (32 * 33);
    const int wb = w0 + warp * 32;                // the warp's first word
    for (int g = 0; g < ngroups; g++) {
        u32 A0[AROWS], A1[AROWS];                 // anchors at w, w + 1
#pragma unroll
        for (int rr = 0; rr < AROWS; rr++) {
            int row = g * OUT_ROWS - 2 + rr;
            bool ok = row >= 0 && row < ns;
            A0[rr] = ok && w < W ? anch[(size_t)row * W + w] : 0u;
            A1[rr] = ok && w + 1 < W ? anch[(size_t)row * W + w + 1] : 0u;
        }
        u32 R[32];
#pragma unroll
        for (int k = 0; k < OUT_ROWS; k++) {
            const int row = g * OUT_ROWS + k;
            u32 e0 = 0, e1 = 0;                   // rows past ns: eq = 0
            if (row < ns) {                       // uniform in the block
                const int s = min_shift + row, q = s >> 5, b = s & 31;
                u32 la = lo[i + q], lb = lo[i + q + 1], lc = lo[i + q + 2];
                u32 ha = hi[i + q], hb = hi[i + q + 1], hc = hi[i + q + 2];
                e0 = eq_planes(L0, H0, la, lb, ha, hb, b);
                e1 = eq_planes(L1, H1, lb, lc, hb, hc, b);
            }
            u32 o0 = e0 | A0[k] | A0[k + 1] | A0[k + 3] | A0[k + 4];
            u32 o1 = e1 | A1[k] | A1[k + 1] | A1[k + 3] | A1[k + 4];
            R[k] = few_zeros(o0, o1, 0u) & nfree;                // q6
            R[OUT_ROWS + k] = few_zeros(e0, e1, ~0u) & nfree;   // q7
            R[2 * OUT_ROWS + k] = e0 & notn;                    // pm
            R[3 * OUT_ROWS + k] = 0u;
        }
        transpose32(R);                           // R[j]: position 32 w + j
        __syncwarp();
#pragma unroll
        for (int j = 0; j < 32; j++)
            sg[lane * 33 + j] = R[j];
        __syncwarp();
        int32_t *o = out + (size_t)g * L + (size_t)wb * 32 + lane;
        const int rem = L - wb * 32 - lane;       // > 32 j: o[32 j] in the row
#pragma unroll 8
        for (int j = 0; j < 32; j++)
            if (rem > 32 * j)
                o[32 * j] = (int32_t)sg[j * 33 + lane];
    }
}

#define MROWS 8        // motif rows per block in the dense pass

// Length of the pm run from bit b of word wl is at least cutoff; pm words
// are eq & ~N, walked past the word with __ffs as the anchor pass does.
__device__ __forceinline__ bool run_at_least(const u32 *e, const u32 *nw,
                                             int wl, int b, int cutoff,
                                             int EW)
{
    u32 inv = ~((e[wl] & ~nw[wl]) >> b);   // ones above bit 31 - b
    int len = inv ? __ffs(inv) - 1 : 32;
    if (len < 32 - b)
        return len >= cutoff;
    for (int k = wl + 1; k < EW && len < cutoff; k++) {
        u32 nx = ~(e[k] & ~nw[k]);
        int c = nx ? __ffs(nx) - 1 : 32;
        len += c;
        if (c < 32)
            break;
    }
    return len >= cutoff;
}

// Grid: (tiles of TW words, groups of MROWS motif rows).  Shared memory:
// the code tile over words [w0 - 1, w0 + TW + H) plus s_max bytes, the
// n_mask tile, the N bit-words (positions < 0 or >= L set), and eq and
// overlay bit-words of the group's rows over the same words.  The left word
// gives pm[p - 1] at the tile's first position; the H right words serve
// windows that start in the tile's last word and the run walk up to the
// largest cutoff.  A thread takes four positions of one row.
__global__ void dense_masks_kernel(const uint8_t *__restrict__ code,
                                   const uint8_t *__restrict__ nmask,
                                   const u32 *__restrict__ anch, int L,
                                   int min_shift, int ns, int r0, int nm,
                                   int H, int W, int8_t *__restrict__ out)
{
    extern __shared__ unsigned char smem[];
    const int EW = 1 + TW + H;
    const int s_max = min_shift + r0 + nm - 1;
    const int ncode = EW * 32 + s_max;
    uint8_t *sc = smem;
    uint8_t *sn = smem + ((ncode + 15) & ~15);
    u32 *nw = (u32 *)(sn + EW * 32);
    u32 *eqw = nw + EW;
    u32 *ovw = eqw + MROWS * EW;

    const int w0 = blockIdx.x * TW;
    const int k0 = blockIdx.y * MROWS;
    const int pbase = (w0 - 1) * 32;           // global position of sc[0]

    for (int i = threadIdx.x; i < ncode; i += THREADS) {
        int p = pbase + i;
        bool in = p >= 0 && p < L;
        sc[i] = in ? code[p] : 0;
        if (i < EW * 32)
            sn[i] = in ? nmask[p] : 1;
    }
    __syncthreads();

    for (int i = threadIdx.x; i < EW; i += THREADS) {
        u32 w = 0;
        for (int j = 0; j < 32; j++)
            w |= (u32)(sn[i * 32 + j] != 0) << j;
        nw[i] = w;
    }
    for (int i = threadIdx.x; i < MROWS * EW; i += THREADS) {
        int r = i % MROWS, wl = i / MROWS;
        int k = k0 + r, gw = w0 - 1 + wl;
        u32 eq = 0, ov = 0;
        if (k < nm) {
            int row = r0 + k;
            eq = eq_word(sc, wl * 32, pbase + wl * 32, min_shift + row, L);
            if (gw >= 0 && gw < W) {
                for (int d = -2; d <= 2; d++) {
                    int nr = row + d;
                    if (d != 0 && nr >= 0 && nr < ns)
                        ov |= anch[(size_t)nr * W + gw];
                }
            }
        }
        eqw[r * EW + wl] = eq;
        ovw[r * EW + wl] = eq | ov;
    }
    __syncthreads();

    const int QT = TW * 8;                     // quads of positions per row
    for (int i = threadIdx.x; i < MROWS * QT; i += THREADS) {
        int r = i / QT, q = i % QT;
        int k = k0 + r;
        int p = w0 * 32 + 4 * q;
        if (k >= nm)
            break;
        if (p >= L)
            continue;
        int wl = 1 + (q >> 3), sh = (q & 7) * 4;
        int m = min_shift + r0 + k;
        int cutoff = m <= 6 ? 12 - m : m;
        const u32 *e = eqw + r * EW, *o = ovw + r * EW;
        u32 n8 = __funnelshift_r(nw[wl], nw[wl + 1], sh);
        u32 e8 = __funnelshift_r(e[wl], e[wl + 1], sh);
        u32 o8 = __funnelshift_r(o[wl], o[wl + 1], sh);
        u32 pmb = e8 & ~n8;
        u32 prev = sh ? (e[wl] & ~nw[wl]) >> (sh - 1)
                      : (e[wl - 1] & ~nw[wl - 1]) >> 31;
        u32 v7 = 0, v6 = 0, vs = 0, vm = 0;
#pragma unroll
        for (int j = 0; j < 4; j++) {
            bool nfree = ((n8 >> j) & 0xffu) == 0;
            u32 b7 = nfree && __popc((e8 >> j) & 0xffu) >= 7;
            u32 b6 = nfree && __popc((o8 >> j) & 0xffu) >= 6;
            u32 bm = (pmb >> j) & 1u;
            u32 bp = (j ? pmb >> (j - 1) : prev) & 1u;
            u32 bs = bm && !bp
                     && run_at_least(e, nw, wl, sh + j, cutoff, EW);
            v7 |= b7 << (8 * j);
            v6 |= b6 << (8 * j);
            vs |= bs << (8 * j);
            vm |= bm << (8 * j);
        }
        const u32 v[4] = {v7, v6, vs, vm};
        for (int pl = 0; pl < 4; pl++) {
            int8_t *dst = out + ((size_t)pl * nm + k) * L + p;
            if ((((size_t)dst) & 3) == 0 && p + 3 < L) {
                *(u32 *)dst = v[pl];
            } else {
                for (int j = 0; j < 4 && p + j < L; j++)
                    dst[j] = (int8_t)((v[pl] >> (8 * j)) & 1u);
            }
        }
    }
}

static int launch_smem(const void *fn, size_t smem)
{
    if (smem > 48 * 1024)
        return (int)cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    return 0;
}

// All pointers are device pointers on `device`; the launch goes onto
// `stream` and does not synchronise.  Returns cudaGetLastError().
extern "C" int ribbit_anchor_planes(const uint8_t *code, int L, int min_shift,
                                    int ns, u32 *out, int W, int device,
                                    cudaStream_t stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess)
        return (int)err;
    const int s_max = min_shift + ns - 1;
    const int K = (2 * s_max + 31) / 32;
    const int NP = AT + 2 * (K + 1) + (s_max >> 5) + 1;
    const size_t smem = (size_t)2 * NP * sizeof(u32);
    int rc = launch_smem((const void *)anchor_planes_kernel, smem);
    if (rc)
        return rc;
    anchor_planes_kernel<<<(W + AT - 1) / AT, AT, smem, stream>>>(
        code, L, min_shift, ns, K, out, W);
    return (int)cudaGetLastError();
}

extern "C" int ribbit_event_words(const uint8_t *code, const uint8_t *nmask,
                                  const u32 *anch, int L, int min_shift,
                                  int ns, int ngroups, int32_t *out,
                                  int device, cudaStream_t stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess)
        return (int)err;
    const int s_max = min_shift + ns - 1;
    const int W = (L + 31) / 32;
    const int EW = EV_T + (s_max + 31) / 32 + 2;
    const size_t smem = (size_t)(3 * EW + EV_WARPS * 32 * 33) * sizeof(u32);
    int rc = launch_smem((const void *)event_words_kernel, smem);
    if (rc)
        return rc;
    event_words_kernel<<<(W + EV_T - 1) / EV_T, EV_T, smem, stream>>>(
        code, nmask, anch, L, min_shift, ns, ngroups, W, out);
    return (int)cudaGetLastError();
}

// Motif rows k = 0..nm-1 are shift rows r0 + k.  out: int8 [4, nm, L].
extern "C" int ribbit_dense_masks(const uint8_t *code, const uint8_t *nmask,
                                  const u32 *anch, int L, int min_shift,
                                  int ns, int r0, int nm, int8_t *out,
                                  int device, cudaStream_t stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess)
        return (int)err;
    int cut_max = 0;
    for (int k = 0; k < nm; k++) {
        int m = min_shift + r0 + k;
        int c = m <= 6 ? 12 - m : m;
        cut_max = c > cut_max ? c : cut_max;
    }
    const int H = (cut_max + 31) / 32 + 1;
    const int s_max = min_shift + r0 + nm - 1;
    const int W = (L + 31) / 32;
    const int EW = 1 + TW + H;
    const size_t smem = (size_t)((EW * 32 + s_max + 15) & ~15)
                        + (size_t)EW * 32
                        + (size_t)(1 + 2 * MROWS) * EW * sizeof(u32);
    int rc = launch_smem((const void *)dense_masks_kernel, smem);
    if (rc)
        return rc;
    dim3 grid((L + TW * 32 - 1) / (TW * 32), (nm + MROWS - 1) / MROWS);
    dense_masks_kernel<<<grid, THREADS, smem, stream>>>(
        code, nmask, anch, L, min_shift, ns, r0, nm, H, W, out);
    return (int)cudaGetLastError();
}
