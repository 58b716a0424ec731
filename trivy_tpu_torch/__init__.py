"""trivy_tpu_torch — the PyTorch/CUDA port of trivy_tpu for NVIDIA Hopper.

The vulnerability match runs on the card: the advisory DB compiles into
the same sorted name-hash column and interleaved row table as in
trivy_tpu, resident on a CUDA device, and a hand-written CUDA kernel
(ops/csrc/match.cu) does the name join and version-interval test for a
whole query batch. The host decodes the packed hit words and rescreens
the flagged candidates with the exact comparators, so match sets equal
the CPU oracle's.

Secret scanning runs on the card too (secret/scanner.py): every rule and
keyword compiles to an anchor of up to 8 byte classes, hand-written
CUDA kernels screen 16 KiB chunks of a whole file batch for them
(ops/csrc/secret_anchor.cu, secret_conv.cu), and the host regex runs
only inside the candidate windows, so findings equal the host path's.
The keyword prefilter (ops/secret_prefilter.py) has its own kernel
(ops/csrc/secret_prefilter.cu).

The package imports torch, never jax, and nothing of trivy_tpu: the
device-free modules it needs are its own copies.
"""

__version__ = "0.1.0"
