"""Serving and training telemetry of the port, each module its own copy of
the JAX package's module of the same name: the metrics registry
(metrics.py), the SLO sketches of /loadz (sketch.py), the shared
HTTP-response counter (httpstats.py), spans and traceparent propagation
(tracing.py, propagation.py), request journeys and the slow ring
(journey.py), the engine's step timeline (timeline.py), events
(events.py) and the /debug pages' RBAC check (authz.py)."""
