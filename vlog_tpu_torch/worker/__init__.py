"""Worker runtime: the per-video pipeline, audio renditions, sprites and
transcription, and the two workers that run them, the sqlite daemon and
the remote worker over the Worker API (port of ``vlog_tpu/worker``)."""

from vlog_tpu_torch.worker.pipeline import ProcessResult, process_video  # noqa: F401
