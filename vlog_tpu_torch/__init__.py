"""PyTorch/CUDA port of the vlog_tpu compute: the per-video pipeline
(``worker.process_video``: the H.264 ladder, the AAC renditions,
verification, the manifest), sprites and captions, and the workers that
run them: the sqlite daemon and the remote worker with the Worker API
it talks to.

The package stands beside ``vlog_tpu`` and imports nothing from it: the
JAX package is the reference, and every function here is tested against
its counterpart on the same numpy inputs. Entry points take an explicit
``device`` (default ``"cuda"``) and raise when CUDA is missing; only the
CPU tests pass ``device="cpu"``.
"""

import torch

# TF32 off for both float32 paths. The ladder resize is two float32
# products whose result is rounded to uint8: TF32 keeps 10 mantissa bits,
# which moves the rounded pixels by whole levels and breaks the stated
# |diff| <= 1 contract with the JAX reference (and the comparison of the
# hand-written kernel with its plain version). Matmul TF32 is already off
# by default; cuDNN TF32 is on by default, so both are set explicitly.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
