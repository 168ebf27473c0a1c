// Forward flash attention (causal or not, GQA) for NVIDIA Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py:_body
// (launched by flash_attention_kernel) and computes what it computes:
// per query row an online softmax over the keys with (m, l, acc) in fp32,
// scale 1/sqrt(dh), masked scores -1e30, the output divided by
// max(l, 1e-30) and cast to the input type.  Inputs are widened to fp32
// before both products, as the TPU kernel does.
//
// Design.  The TPU kernel walks a sequential (B, KV, G, nQ, nK) grid and
// keeps (m, l, acc) in VMEM scratch across the nK axis.  Blocks on this card
// run in parallel and in no order, so here one thread block owns one
// (b, h, query block of BQ rows) and loops over the key blocks itself,
// stopping at the diagonal when causal.  Each key block is staged in shared
// memory (K transposed, V as is, both widened to fp32); (m, l, acc) live in
// registers.  256 threads form a 16 x 16 grid: a thread owns query rows
// ty + 16 i (i < 4), key columns tx + 16 j (j < 4) of the score tile and
// output columns tx + 16 c (c < 8), so dh and dv up to 128 fit.  Row
// statistics are reduced over the 16 threads of a row with warp shuffles.
// Rows past Sq and keys past Sk are masked here, so S need not be a
// multiple of the block.
//
// What bounds it.  At the serving shape of llama3-8b (B=4, S=1024, H=32,
// KV=8, dh=dv=128, bf16, causal) the work is 34.4 GFLOP (the causal half
// of both products) against 84 MB moved: 0.035 ms at 989 TFLOP/s of bf16
// tensor-core rate against 0.025 ms at 3.35 TB/s, so the products bound it.
// This simple design does them as fp32 FMAs on the CUDA cores (67 TFLOP/s
// peak) out of shared memory, so it leaves more than an order of magnitude
// on the table: wgmma on bf16 tiles, TMA loads into a ring of buffers that
// overlaps the next block's copy with this block's math, and skipping the
// masked half of the diagonal block are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 64;                 // keys per staged block
constexpr int TX = 16;                 // threads along keys / output columns
constexpr int TY = 16;                 // threads along query rows
constexpr int THREADS = TX * TY;
constexpr int RQ = BQ / TY;            // query rows per thread
constexpr int RK = BK / TX;            // key columns per thread
constexpr int MAX_D = 128;
constexpr int RV = MAX_D / TX;         // output columns per thread
constexpr int KSTR = BK + 1;           // padded row of the K^T and P tiles
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void narrow(float x, float* out) { *out = x; }
__device__ __forceinline__ void narrow(float x, __nv_bfloat16* out) { *out = __float2bfloat16(x); }

// Shared memory, in floats: Q tile [BQ][dh+1], then a region that holds
// K^T [dh][KSTR] while scores are formed and P [BQ][KSTR] after, then the
// V tile [BK][dv].
__host__ __device__ inline int kp_floats(int dh) { return (dh > BQ ? dh : BQ) * KSTR; }
__host__ __device__ inline int smem_floats(int dh, int dv) {
    return BQ * (dh + 1) + kp_floats(dh) + BK * dv;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o,
          int Sq, int Sk, int H, int KV, int dh, int dv, int causal,
          float scale) {
    extern __shared__ float smem[];
    const int qstr = dh + 1;
    float* Qs = smem;
    float* KP = Qs + BQ * qstr;
    float* Vs = KP + kp_floats(dh);

    const int q0 = blockIdx.x * BQ;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int kvh = h / (H / KV);
    const int tid = threadIdx.x;
    const int tx = tid % TX;
    const int ty = tid / TX;

    // (B, S, heads, d) row-major: row s of head h starts at (s * heads + h) * d
    const T* qb = q + ((size_t)b * Sq * H + h) * dh;
    const T* kb = k + ((size_t)b * Sk * KV + kvh) * dh;
    const T* vb = v + ((size_t)b * Sk * KV + kvh) * dv;
    T* ob = o + ((size_t)b * Sq * H + h) * dv;
    const size_t q_row = (size_t)H * dh;
    const size_t k_row = (size_t)KV * dh;
    const size_t v_row = (size_t)KV * dv;

    for (int i = tid; i < BQ * dh; i += THREADS) {
        const int r = i / dh, d = i % dh, s = q0 + r;
        Qs[r * qstr + d] = s < Sq ? widen(qb[s * q_row + d]) : 0.f;
    }

    float m[RQ], l[RQ], acc[RQ][RV];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < RV; ++c) acc[i][c] = 0.f;
    }

    // keys past the last query row of this block are all masked when causal
    const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
    for (int k0 = 0; k0 < k_end; k0 += BK) {
        __syncthreads();  // the previous block's P and V are no longer read
        for (int i = tid; i < BK * dh; i += THREADS) {
            const int r = i / dh, d = i % dh, s = k0 + r;
            KP[d * KSTR + r] = s < Sk ? widen(kb[s * k_row + d]) : 0.f;
        }
        for (int i = tid; i < BK * dv; i += THREADS) {
            const int r = i / dv, d = i % dv, s = k0 + r;
            Vs[r * dv + d] = s < Sk ? widen(vb[s * v_row + d]) : 0.f;
        }
        __syncthreads();

        float sc[RQ][RK];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
            for (int j = 0; j < RK; ++j) sc[i][j] = 0.f;
        for (int d = 0; d < dh; ++d) {
            float qv[RQ], kv[RK];
#pragma unroll
            for (int i = 0; i < RQ; ++i) qv[i] = Qs[(ty + TY * i) * qstr + d];
#pragma unroll
            for (int j = 0; j < RK; ++j) kv[j] = KP[d * KSTR + tx + TX * j];
#pragma unroll
            for (int i = 0; i < RQ; ++i)
#pragma unroll
                for (int j = 0; j < RK; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
        }
        __syncthreads();  // K^T is read by all; P overwrites it below

#pragma unroll
        for (int i = 0; i < RQ; ++i) {
            const int r = ty + TY * i;
            const int qpos = q0 + r;
            float mx = NEG_INF;
#pragma unroll
            for (int j = 0; j < RK; ++j) {
                const int kpos = k0 + tx + TX * j;
                const bool keep = kpos < Sk && (!causal || kpos <= qpos);
                sc[i][j] = keep ? sc[i][j] * scale : NEG_INF;
                mx = fmaxf(mx, sc[i][j]);
            }
#pragma unroll
            for (int off = TX / 2; off > 0; off /= 2)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[i], mx);
            float rs = 0.f;
#pragma unroll
            for (int j = 0; j < RK; ++j) {
                const float p = expf(sc[i][j] - m_new);
                KP[r * KSTR + tx + TX * j] = p;
                rs += p;
            }
#pragma unroll
            for (int off = TX / 2; off > 0; off /= 2)
                rs += __shfl_xor_sync(0xffffffffu, rs, off);
            const float corr = expf(m[i] - m_new);
            l[i] = l[i] * corr + rs;
            m[i] = m_new;
#pragma unroll
            for (int c = 0; c < RV; ++c) acc[i][c] *= corr;
        }
        __syncthreads();

        for (int kk = 0; kk < BK; ++kk) {
            float pv[RQ], vv[RV];
#pragma unroll
            for (int i = 0; i < RQ; ++i) pv[i] = KP[(ty + TY * i) * KSTR + kk];
#pragma unroll
            for (int c = 0; c < RV; ++c) {
                const int col = tx + TX * c;
                vv[c] = col < dv ? Vs[kk * dv + col] : 0.f;
            }
#pragma unroll
            for (int i = 0; i < RQ; ++i)
#pragma unroll
                for (int c = 0; c < RV; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
        }
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
        const int s = q0 + ty + TY * i;
        if (s >= Sq) continue;
        const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
        for (int c = 0; c < RV; ++c) {
            const int col = tx + TX * c;
            if (col < dv) narrow(acc[i][c] / denom, &ob[s * (size_t)H * dv + col]);
        }
    }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Sk, int H, int KV, int dh, int dv, int causal, float scale,
           cudaStream_t stream) {
    const size_t smem = (size_t)smem_floats(dh, dv) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((Sq + BQ - 1) / BQ, H, B);
    flash_fwd<T><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, KV, dh, dv,
        causal, scale);
    return (int)cudaGetLastError();
}

}  // namespace

// C entry point bound with ctypes.  q (B,Sq,H,dh), k (B,Sk,KV,dh),
// v (B,Sk,KV,dv), o (B,Sq,H,dv), all contiguous and of one type:
// dtype 0 is float32, 1 is bfloat16.  The caller checks shapes (H % KV == 0,
// dh and dv in 1..128).  Returns the CUDA error code of the launch, 0 on
// success; the kernel runs on `stream` and nothing is synchronised.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, int B, int Sq,
                                         int Sk, int H, int KV, int dh, int dv,
                                         int causal, float scale, int dtype,
                                         void* stream) {
    if (dh < 1 || dh > MAX_D || dv < 1 || dv > MAX_D || KV < 1 || H % KV != 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch<float>(q, k, v, o, B, Sq, Sk, H, KV, dh, dv, causal, scale, s);
    if (dtype == 1)
        return launch<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KV, dh, dv, causal, scale, s);
    return (int)cudaErrorInvalidValue;
}
