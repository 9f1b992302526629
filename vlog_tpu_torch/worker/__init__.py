"""Worker runtime: the per-video pipeline, audio renditions, sprites and
transcription (port of ``vlog_tpu/worker``)."""

from vlog_tpu_torch.worker.pipeline import ProcessResult, process_video  # noqa: F401
