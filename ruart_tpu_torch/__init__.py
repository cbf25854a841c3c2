"""ruart_tpu_torch — the PyTorch / CUDA port of ruart_tpu for NVIDIA Hopper.

It does what the JAX package does — serving (raw requests -> host
featurization -> collate -> RUArt forward -> answer decode), training and
prediction through the CLIs, every conf branch of the model, the (dp, tp)
mesh of ranks and the library surface — on one H100 or one card per rank.
Every BERT attention goes through the hand-written CUDA kernel in
``csrc/attention.cu``; the host's PHOC encoder and the collator's fill
loops are C++ built with g++ at first use (``native/``); the rest is stock
PyTorch. The package imports neither JAX nor ``ruart_tpu``: host modules
it needs are kept here as copies, so each module's counterpart sits at
the same path under ``ruart_tpu/``.
"""

__version__ = "0.1.0"
