// The last pass of the vocab-streamed cross-entropy forward (B4), shared by
// its 16-bit kernel (xent_fwd_sm90.cu, which defines it) and its fp32
// kernel (xent_fwd_f32_sm90.cu): each vocab share j of a row left a partial max
// m_j and sum s_j of exp(logit - m_j) in (splits, N) arrays; per row,
// lse = M + log(sum_j s_j exp(m_j - M)) with M the largest m_j, and
// nll = lse - the target logit. The shares are summed in a fixed order.

#pragma once

#include <cuda_runtime.h>

namespace bllm {
namespace xent {

// the value padded vocabulary columns take before the max and the sum
constexpr float kNegBig = -1e30f;

// launches the combine on `stream` and returns cudaGetLastError()
int combine(const float* m_part, const float* s_part, const float* tl, float* nll, float* lse,
            int N, int splits, cudaStream_t stream);

}  // namespace xent
}  // namespace bllm
