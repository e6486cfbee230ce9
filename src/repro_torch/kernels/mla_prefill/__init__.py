"""DeepSeek-V2/V3's MLA prefill attention (causal, qk 128 + 64, v 128)."""
