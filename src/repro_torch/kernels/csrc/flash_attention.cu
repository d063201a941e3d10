// Flash attention forward for Hopper (sm_90a), on the tensor cores.
//
// flash_attention_bf16 / flash_attention_f32 replace the Pallas kernel
//   flash_attention of src/repro/kernels/flash_attention.py:89 (body
//   _fa_kernel :35, pallas_call :111): online-softmax attention over kv
//   tiles, GQA by kv head h / (H / Hkv), causal masking with q_offset =
//   Skv - S (queries are the last S positions) and masked scores set to
//   -1e30, fully masked causal kv tiles skipped, output acc / max(l,
//   1e-30) in the inputs' dtype.  The value width Dv may differ from D.
//   Unlike the Pallas kernel, S and Skv need not be tile multiples: rows
//   past S are never stored and keys past Skv take no part (score -inf,
//   weight 0), which is the reference's plain attention on those shapes.
//
// Bound on this card: operations.  At the bi-encoder's shapes (H 12,
// S = Skv = 256, D 64) a sequence does 4*H*S*Skv*D = 2.0e8 flops on
// 3.1 MB of float32 q, k, v and output: 1.2 us at the 3xTF32 rate (495 /
// 3 TFLOP/s), 3.0 us at 67 TFLOP/s float32 FMA, against 0.94 us of bytes.
// Yi-9B's bf16 prefill (H 32 / 4, S 784, D 128) does 1.6e10 flops: 16 us
// at 989 TFLOP/s.
//
// What the design does about it (FlashAttention-2 on mma.sync):
//  * one block of NW warps (1 or 4; tiling.plan_flash_attention takes 4
//    when that still gives a block to each of the 132 SMs, so Dragon's
//    B = 1 shape runs 192 one-warp blocks, not 48) per (batch x head,
//    16 NW query rows), the heaviest causal row tiles first; each warp
//    owns 16 query rows, its Q fragments in registers for the whole row;
//  * K and V stream through a double-buffered cp.async ring of 64-key
//    tiles in dynamic shared memory (zero-filled past Skv and past the
//    head dim), the next tile in flight while this one is computed; rows
//    are padded so the fragment reads are conflict-free; causal tiles past
//    the block's (and each warp's) last query are skipped;
//  * bf16 inputs (flash_bf16_kernel): Q K^T as mma.m16n8k16 bf16 -> f32,
//    K by ldmatrix; the scale multiplies the f32 scores after the dot;
//    online softmax in registers (row max and sum over the quad); P from
//    the accumulators as the A operand, two bf16 terms (hi + lo), V by
//    ldmatrix.trans; the output in bf16;
//  * float32 inputs (flash_tf32_kernel): every product in 3xTF32 on
//    mma.m16n8k8 (a_hi b_hi + a_hi b_lo + a_lo b_hi, float32 accuracy: the
//    towers hold embeddings to 1e-5, which neither one tf32 pass nor bf16
//    does); the contraction index is permuted (k t <-> 2t, t + 4 <-> 2t +
//    1, alike in both operands) so K rows are read as float2 and P stays
//    in registers; V is read per element.
//
// Head widths.  An instance is built for a key bucket DK and a value
// bucket DV (columns past D and Dv are zero-filled and never stored):
//  * D, Dv <= 128 ("narrow", this source): DK = DV = 64 or 128, 1 or 4
//    warps, the Q fragments in registers for the whole row, bf16 three
//    stages, f32 two;
//  * otherwise ("wide", up to 256, flash_attention_wide.cu: MLA's prefill
//    is D = 192, Dv = 128): 4 warps, DK 128 / 192 / 256 and DV 128 / 256
//    apart, so (192, 128) carries a 128-wide output accumulator.  Q no
//    longer fits the registers beside the accumulator (f32 at D = 192:
//    96 registers of raw Q), so the block stages its 64 query rows once
//    in shared memory (rows DK + 8) and each k step reads its fragment
//    from there (bf16: ldmatrix; f32: float2, split per use).  Two stages
//    of K and V; one where two do not fit a block (f32 with DK + DV >
//    320: (256, 256) would take 2 x 64 x (264 + 260) x 4 = 268 KB of the
//    227 KB): the tile then loads, waits and is computed in turn.  A
//    smaller kv tile would keep the overlap, but every instance keeps the
//    64-key tile, and with it one softmax code and summation order.
//
// Plain C interface (bound with ctypes): returns a cudaError_t as int, 0
// when the launch was accepted.

#include "flash_attention.cuh"

namespace {

using namespace flash_attention;

// The narrow instance of the buckets of D and Dv (tiling.attn_bucket):
// 64 / 64 or 128 / 128, at 1 or 4 warps; a wider head goes to the wide
// instances (4 warps).
template <typename T>
int by_bucket(const Args& a, int B, int warps, cudaStream_t s) {
  if (a.D > NARROW_DIM || a.Dv > NARROW_DIM)
    return warps != 4 ? (int)cudaErrorInvalidValue
           : std::is_same_v<T, float> ? launch_wide_f32(a, B, s)
                                      : launch_wide_bf16(a, B, s);
  const bool wide = a.D > 64 || a.Dv > 64;
  if (warps == 4)
    return wide ? launch<T, 4, 128, 128>(a, B, s)
                : launch<T, 4, 64, 64>(a, B, s);
  return wide ? launch<T, 1, 128, 128>(a, B, s)
              : launch<T, 1, 64, 64>(a, B, s);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int H, int Hkv, int S, int Skv, int D, int Dv, int causal,
             float scale, int warps, const long long* st, void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (B * H == 0 || S == 0) return 0;
  if (D < 1 || D > MAX_DIM || Dv < 1 || Dv > MAX_DIM || D % VEC ||
      Dv % VEC || Skv < 1 || Hkv < 1 || H % Hkv != 0 ||
      (warps != 1 && warps != 4))
    return (int)cudaErrorInvalidValue;
  const Args a{q,     k,     v,     out,   H,     Hkv,   S,
               Skv,   D,     Dv,    causal, scale, st[0], st[1],
               st[2], st[3], st[4], st[5], st[6], st[7], st[8]};
  return by_bucket<T>(a, B, warps, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// q (B, H, S, D), k (B, Hkv, Skv, D), v (B, Hkv, Skv, Dv) bfloat16 with
// element strides strides[0..8] = (batch, head, row) of q, k and v (the
// last dim contiguous, rows 16-byte aligned); out (B, H, S, Dv) bfloat16
// contiguous.  Hkv divides H; D, Dv multiples of 8, at most 256; Skv >= 1;
// warps 1 or 4 (query rows of a block: 16 x warps).  scale is the float32
// value of 1 / sqrt(D).
int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* out, int B, int H, int Hkv, int S, int Skv,
                         int D, int Dv, int causal, float scale, int warps,
                         const long long* strides, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, out, B, H, Hkv, S, Skv, D, Dv,
                                 causal, scale, warps, strides, stream);
}

// As flash_attention_bf16 in float32; D and Dv multiples of 4.
int flash_attention_f32(const void* q, const void* k, const void* v,
                        void* out, int B, int H, int Hkv, int S, int Skv,
                        int D, int Dv, int causal, float scale, int warps,
                        const long long* strides, void* stream) {
  return dispatch<float>(q, k, v, out, B, H, Hkv, S, Skv, D, Dv, causal,
                         scale, warps, strides, stream);
}

}  // extern "C"
