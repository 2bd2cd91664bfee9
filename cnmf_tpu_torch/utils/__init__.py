from cnmf_tpu_torch.utils.timing import stage_timer, timings, profiler_trace  # noqa: F401
