"""Compute on tensors: scoring, top-k, quantization and the flat scan.

``cuda_scan.flat_topk`` is the store's engine: a hand-written CUDA kernel
on the card, its plain torch version on the CPU.
"""
