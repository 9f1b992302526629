"""ASR: Whisper in PyTorch on an explicit device.

The port of ``vlog_tpu/asr``: the log-mel frontend, the encoder-decoder
forward, batched greedy and beam decoding with Whisper's timestamp
rules, checkpoint loading without ``transformers``, and the
continuous-batching engine (on the mesh scheduler's leases, a batch's
rows split over a wide lease's devices).
"""

from vlog_tpu_torch.asr.mel import log_mel_spectrogram  # noqa: F401
