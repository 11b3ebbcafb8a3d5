"""Training-side pieces of the port.  Only ``elastic`` is ported so far: the
fleet planner, heartbeats and straggler monitor that
``repro_torch.serving.elastic`` drives (the rest is ROADMAP.md A.15)."""
