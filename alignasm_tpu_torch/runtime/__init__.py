"""Runtime orchestration of the port: the bucket scheduler, routing and
its calibration, resume."""
