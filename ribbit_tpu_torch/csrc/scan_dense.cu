// Dense match bits and their 8-window sums, written for Hopper (sm_90a).
//
// eq_sum8_kernel replaces _scan_kernel_body (ribbit_tpu/scan_pallas.py:44),
// the first half of the JAX package's dense device scan.  For every shift
// row r (shift s = min_shift + r, r < ns) and position p < L it computes
//
//     eq[r][p]   = code0[p] == code0[p + s]
//     sum8[r][p] = sum over k < 8 of (code0[p + k] == code0[p + k + s])
//
// where code0 is the code padded with zeros past L (the reference's
// zero-fill tail; N bases encode as 0 too).  The last 7 windows of a row
// therefore count pad positions as matches, exactly as the Pallas kernel
// does on its zero-padded buffer.  Outputs: uint8 [ns, L] each.  Every row
// runs in one launch, and nothing depends on the largest shift: the Pallas
// kernel's 128-lane halo caps min_shift + nshifts + 7 at 128, this one has
// no cap.
//
// What bounds it on this card: the output bytes.  It reads L code bytes
// and writes 2 B per position and shift row (1,712 MB for one 8,392,704 bp
// segment at the default 102 rows, 0.51 ms at 3.35 TB/s) against about two
// integer operations per position and row.  The design: a block stages the
// code of its tile ("here", TILE + 7 bytes) and of the tile moved by its
// first row's shift ("there", TILE + RB + 7 bytes) in shared memory, so
// the staging does not grow with the shift.  A thread takes one row and
// four consecutive positions, forms their 11 compares, slides the window
// sum across the four, and writes each output as one 32-bit store of four
// bytes; neighbouring threads take neighbouring quads of one row, so a
// warp's stores are 128 contiguous bytes.

#include <cuda_runtime.h>
#include <stdint.h>

typedef uint32_t u32;

#define THREADS 256
#define TILE 1024      // positions per block
#define RB 16          // shift rows per block
#define WIN 8          // window length

__global__ void eq_sum8_kernel(const uint8_t *__restrict__ code, int L,
                               int min_shift, int ns,
                               uint8_t *__restrict__ eq,
                               uint8_t *__restrict__ sum8)
{
    __shared__ uint8_t here[TILE + WIN];
    __shared__ uint8_t there[TILE + RB + WIN];

    const long long base = (long long)blockIdx.x * TILE;
    const int r0 = blockIdx.y * RB;
    const long long tbase = base + min_shift + r0;   // code0 index of there[0]

    for (int i = threadIdx.x; i < TILE + WIN; i += THREADS) {
        long long p = base + i;
        here[i] = p < L ? code[p] : 0;
    }
    for (int i = threadIdx.x; i < TILE + RB + WIN; i += THREADS) {
        long long p = tbase + i;
        there[i] = p < L ? code[p] : 0;
    }
    __syncthreads();

    const int QT = TILE / 4;                   // quads of positions per row
    for (int i = threadIdx.x; i < RB * QT; i += THREADS) {
        const int r = i / QT, q = i % QT;
        const int row = r0 + r;
        if (row >= ns)
            break;                             // rows only grow with i
        const long long p = base + 4 * q;
        if (p >= L)
            continue;
        const uint8_t *h = here + 4 * q, *t = there + r + 4 * q;
        u32 c[11];
#pragma unroll
        for (int j = 0; j < 11; j++)
            c[j] = h[j] == t[j];
        u32 s = 0;
#pragma unroll
        for (int j = 0; j < WIN; j++)
            s += c[j];
        u32 ve = 0, vs = 0;
#pragma unroll
        for (int j = 0; j < 4; j++) {
            ve |= c[j] << (8 * j);
            vs |= s << (8 * j);
            s = s + c[j + WIN] - c[j];
        }
        const size_t off = (size_t)row * L + p;
        uint8_t *de = eq + off, *ds = sum8 + off;
        if (p + 3 < L && ((((size_t)de) | ((size_t)ds)) & 3) == 0) {
            *(u32 *)de = ve;
            *(u32 *)ds = vs;
        } else {
            for (int j = 0; j < 4 && p + j < L; j++) {
                de[j] = (uint8_t)(ve >> (8 * j));
                ds[j] = (uint8_t)(vs >> (8 * j));
            }
        }
    }
}

// All pointers are device pointers on `device`; the launch goes onto
// `stream` and does not synchronise.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape the grid cannot hold.
extern "C" int ribbit_eq_sum8(const uint8_t *code, int L, int min_shift,
                              int ns, uint8_t *eq, uint8_t *sum8, int device,
                              cudaStream_t stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess)
        return (int)err;
    const int gy = (ns + RB - 1) / RB;
    if (L < 1 || ns < 1 || min_shift < 1 || gy > 65535)
        return (int)cudaErrorInvalidValue;
    dim3 grid((L + TILE - 1) / TILE, gy);
    eq_sum8_kernel<<<grid, THREADS, 0, stream>>>(code, L, min_shift, ns, eq,
                                                 sum8);
    return (int)cudaGetLastError();
}
