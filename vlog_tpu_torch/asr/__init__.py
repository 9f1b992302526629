"""ASR: Whisper in PyTorch on an explicit device.

The port of ``vlog_tpu/asr``: the log-mel frontend, the encoder-decoder
forward, batched greedy and beam decoding with Whisper's timestamp
rules, checkpoint loading without ``transformers``, and the
continuous-batching engine (one device, no mesh scheduler).
"""
