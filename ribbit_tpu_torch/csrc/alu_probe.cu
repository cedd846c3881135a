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
// element against 8 * rounds * trips operations, all in registers.
//
// The trap: a compiler folds these chains.  Adds of a constant
// reassociate (v + c + c becomes one multiply-add, v + a + b one IADD3),
// and pairs of XORs with one constant cancel (an even number of rounds
// returns every XOR chain to x + j).  An empty asm statement hides a value
// from nvcc's optimiser but not from ptxas, which folded the chains behind
// one (pairs of adds into one IMAD or LEA, XOR pairs into a no-op LOP3).
// So each operation's result goes through a byte permute (PRMT) whose
// selector arrives as a kernel argument, 0x3210, the identity: ptxas
// cannot see through it, and nothing fuses across it.  Every operation is
// then one instruction and every permute one more.  The rate is reported
// as the integer instructions of the loop body that cuobjdump lists,
// times the trips and threads that run them, over the time
// (ribbit_tpu_torch/bench_roofline.py counts them).  The round loop is
// unrolled UNROLL times and runs whole bodies only (the launcher refuses
// a remainder), so the body is one block of 8 * UNROLL operations, as
// many permutes, and the loop's own counter and branch.

#include <cuda_runtime.h>
#include <stdint.h>

#define CHAINS 8
#define THREADS 256
#define UNROLL 32

struct Consts {
    int init[CHAINS];      // chain j starts at x + init[j]   (j)
    int op[CHAINS];        // added on even chains, XORed on odd (j, j + 17)
    int sel;               // PRMT selector of the identity, 0x3210
};

__device__ __forceinline__ void opaque(int &v, int sel)
{
    v = (int)__byte_perm((unsigned)v, 0u, (unsigned)sel);
}

__global__ void alu_probe_kernel(const int *__restrict__ x, int n,
                                 int rounds_total, Consts c,
                                 int *__restrict__ out)
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
            for (int j = 0; j < CHAINS; j++) {
                v[j] = (j % 2 == 0) ? v[j] + c.op[j] : v[j] ^ c.op[j];
                opaque(v[j], c.sel);
            }
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
    c.sel = 0x3210;
    const int blocks = (n + THREADS - 1) / THREADS;
    alu_probe_kernel<<<blocks, THREADS, 0, stream>>>(
        x, n, rounds * trips, c, out);
    return (int)cudaGetLastError();
}

// Instructions the caller counts in the SASS loop body cover UNROLL
// rounds of every chain.
extern "C" int ribbit_alu_probe_unroll(void) { return UNROLL; }
