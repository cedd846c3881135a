// int32 ALU probe, written for Hopper (sm_90a).
//
// alu_probe_kernel replaces _alu_kernel (ribbit_tpu/bench_roofline.py:52),
// the JAX package's measured integer ceiling.  It computes the same
// function: for every element x of the input, eight chains start at x + j
// (j = 0..7); each of `trips` blocks applies `rounds` rounds, a round being
// one operation per chain, v += j on even chains and v ^= j + 17 on odd
// ones; the output is the sum of the eight chains, int32 wrapping.
//
// What bounds it: nothing but integer issue.  It reads and writes 4 B per
// element against 8 * rounds * trips operations, all in registers.  An SM
// partition issues one warp instruction a clock, but each of its integer
// pipes takes 16 lanes a clock: the ALU pipe (logic, permutes, compares,
// IADD3) and the FMA pipe (IMAD; VIADD also issues there).  A warp
// instruction holds its pipe for two clocks, so only a loop whose
// instructions fall half on each pipe can issue every clock.
//
// The trap: a compiler folds these chains.  Adds of a constant
// reassociate (v + c + c becomes one multiply-add, v + a + b one IADD3),
// and pairs of XORs with one constant cancel (an even number of rounds
// returns every XOR chain to x + j).  An empty asm statement hides a value
// from nvcc's optimiser but not from ptxas, which folds the chains behind
// one.  So every operation is one instruction that both does it and hides
// it, with no step beside it:
//   - even chains: v = v * one + j, one IMAD on the FMA pipe.  `one` (1)
//     arrives as a kernel argument: without its value ptxas cannot merge
//     (v * one + c) * one + c into one multiply-add.
//   - odd chains: v = (v ^ (j + 17)) & m, one LOP3 on the ALU pipe.  The
//     mask m is all ones and arrives as a kernel argument, in two copies
//     that alternate round by round: two rounds then take four distinct
//     inputs (v, j + 17, m0, m1), which no single LOP3 can, so no pair of
//     rounds can fuse.  With one mask they would take three and could
//     (CUDA 12.8's ptxas kept them apart even so; nothing promises it).
// Both are written as PTX (mad.lo.s32, lop3.b32), so nvcc's own optimiser
// never sees an add or an XOR either.  The loop then has four IMADs and
// four LOP3s a round, half on each pipe, and one compare a body: the
// loop's counter and branch run on the uniform datapath.  On an H100 it
// issues at 95% of the issue limit; 512 blocks of 256 threads leave some
// SM partitions eight warps and others seven, which costs 3% of that.
//
// The rate is reported as the integer instructions of the loop body that
// cuobjdump lists, times the trips and threads that run them, over the
// time (ribbit_tpu_torch/bench_roofline.py counts them).  The round loop
// is unrolled UNROLL times and runs whole bodies only (the launcher
// refuses a remainder), so the body is one block of 8 * UNROLL
// operations and the loop's own counter and branch.  Because the total
// round count is then always even, a kernel that dropped XORs in pairs
// would still equal the plain version; the folding guard
// (bench_roofline.check_probe_loop) refuses a loop body with fewer
// integer instructions than the 8 * UNROLL operations it covers.

#include <cuda_runtime.h>
#include <stdint.h>

#define CHAINS 8
#define THREADS 256
#define UNROLL 128

struct Consts {
    int init[CHAINS];      // chain j starts at x + init[j]   (j)
    int op[CHAINS];        // added on even chains, XORed on odd (j, j + 17)
    int one;               // the even chains' multiplier, 1
    int mask[2];           // the odd chains' masks, alternating, all ones
};

// v * one + c: one IMAD.
__device__ __forceinline__ int mad_step(int v, int one, int c)
{
    int r;
    asm("mad.lo.s32 %0, %1, %2, %3;" : "=r"(r) : "r"(v), "r"(one), "r"(c));
    return r;
}

// (v ^ c) & m: one LOP3 (0xF0 ^ 0xCC) & 0xAA = 0x28.
__device__ __forceinline__ int xor_step(int v, int c, int m)
{
    int r;
    asm("lop3.b32 %0, %1, %2, %3, 0x28;" : "=r"(r) : "r"(v), "r"(c), "r"(m));
    return r;
}

__global__ void __launch_bounds__(THREADS)
alu_probe_kernel(const int *__restrict__ x, int n, int rounds_total,
                 Consts c, int *__restrict__ out)
{
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= n)
        return;
    const int xi = x[i];
    int v[CHAINS];
#pragma unroll
    for (int j = 0; j < CHAINS; j++)
        v[j] = xi + c.init[j];

#pragma unroll 1
    for (int it = 0; it < rounds_total; it += UNROLL) {
#pragma unroll
        for (int u = 0; u < UNROLL; u++) {
#pragma unroll
            for (int j = 0; j < CHAINS; j++)
                v[j] = (j % 2 == 0) ? mad_step(v[j], c.one, c.op[j])
                                    : xor_step(v[j], c.op[j], c.mask[u & 1]);
        }
    }
    int acc = v[0];
#pragma unroll
    for (int j = 1; j < CHAINS; j++)
        acc += v[j];
    out[i] = acc;
}

// x, out: device int32 [n].  rounds = ops / 8 per trip; rounds * trips
// must be a multiple of UNROLL.  Returns cudaGetLastError().
extern "C" int ribbit_alu_probe(const int *x, int n, int rounds, int trips,
                                int *out, int device, cudaStream_t stream)
{
    if ((rounds * trips) % UNROLL)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess)
        return (int)err;
    Consts c;
    for (int j = 0; j < CHAINS; j++) {
        c.init[j] = j;
        c.op[j] = (j % 2 == 0) ? j : j + 17;
    }
    c.one = 1;
    c.mask[0] = c.mask[1] = -1;
    const int blocks = (n + THREADS - 1) / THREADS;
    alu_probe_kernel<<<blocks, THREADS, 0, stream>>>(
        x, n, rounds * trips, c, out);
    return (int)cudaGetLastError();
}

// Instructions the caller counts in the SASS loop body cover UNROLL
// rounds of every chain.
extern "C" int ribbit_alu_probe_unroll(void) { return UNROLL; }
