"""Run observability of the port: the metrics registry whose snapshot
rides every step's stats (:mod:`.metrics`) and the profiler window
(:mod:`.profiling`). Port of the matching parts of
``trlx_tpu/observability/``; the span tracer, health detectors, flight
recorder, watchdogs and cluster telemetry are not ported yet."""
