"""ruart_tpu_torch — the PyTorch / CUDA port of ruart_tpu for NVIDIA Hopper.

It runs the serving path of the JAX package (raw requests -> host
featurization -> collate -> RUArt forward -> answer decode) on one H100.
Every BERT attention goes through the hand-written CUDA kernel in
``csrc/attention.cu``; the rest is stock PyTorch. The package imports
neither JAX nor ``ruart_tpu``: host modules it needs are kept here as
copies, so each module's counterpart sits at the same path under
``ruart_tpu/``.
"""

__version__ = "0.1.0"
