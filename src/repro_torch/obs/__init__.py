"""Event tracing (the ``EV_*`` kinds and the int32 event ring).  The
observability facade, telemetry and kernel profiling are still to port
(ROADMAP.md A.13)."""
