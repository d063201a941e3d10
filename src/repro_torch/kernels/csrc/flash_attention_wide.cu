// The wide instances of the flash attention forward kernels (D or Dv past
// 128, up to 256; design notes in flash_attention.cu): 4-warp blocks, the
// key bucket 128 / 192 / 256 and the value bucket 128 / 256 apart
// (tiling.attn_bucket), so MLA's prefill (D = 192, Dv = 128) carries a
// 128-wide output accumulator.  Built apart from the narrow instances so
// the two compile in parallel.

#include "flash_attention.cuh"

namespace flash_attention {

namespace {

template <typename T>
int by_bucket(const Args& a, int B, cudaStream_t s) {
  const int dk = a.D <= 128 ? 128 : a.D <= 192 ? 192 : 256;
  if (a.Dv <= 128)  // D > 128 here
    return dk == 192 ? launch<T, 4, 192, 128>(a, B, s)
                     : launch<T, 4, 256, 128>(a, B, s);
  if (dk == 128) return launch<T, 4, 128, 256>(a, B, s);
  return dk == 192 ? launch<T, 4, 192, 256>(a, B, s)
                   : launch<T, 4, 256, 256>(a, B, s);
}

}  // namespace

int launch_wide_bf16(const Args& a, int B, cudaStream_t s) {
  return by_bucket<__nv_bfloat16>(a, B, s);
}

int launch_wide_f32(const Args& a, int B, cudaStream_t s) {
  return by_bucket<float>(a, B, s);
}

}  // namespace flash_attention
