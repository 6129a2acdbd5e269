"""The LM substrate's models: dense decoder-only LMs (``lm``) on the
flash-attention kernel for prefill and cached decode attention."""
