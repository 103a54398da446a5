"""vitta_tpu_torch — the PyTorch/CUDA port of vitta_tpu.

ViTTA (CVPR 2023, arXiv:2211.15393) on an NVIDIA H100: online test-time
adaptation of video action-recognition models by aligning per-layer
feature statistics with precomputed source statistics, plus a
multi-view prediction-consistency loss.  The JAX package ``vitta_tpu``
beside it is the reference this port is checked against; the port
imports ``torch`` and never ``jax`` or ``vitta_tpu``.

What runs today: the TANet (ResNet-50+TAM) float32 adapt+eval stream,
``vitta_tpu_torch.adapt.loops.tta_stream(engine, paired_data)``, with the
TAM dynamic temporal conv as a hand-written CUDA kernel
(``csrc/tam.cu``, ``ops/cuda_tam.py``).  Kernels build with ``nvcc`` at
first use on the card; on the CPU every op takes its plain version.
"""

__version__ = "0.1.0"
