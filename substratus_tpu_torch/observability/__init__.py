"""Serving telemetry of the port: the metrics registry (metrics.py), the
SLO sketches of /loadz (sketch.py) and the shared HTTP-response counter
(httpstats.py), the port's own copies of the JAX package's modules of the
same names. Spans, journeys, the step timeline and events wait for ROADMAP
Queue 1 item 3b."""
