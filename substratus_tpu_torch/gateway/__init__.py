"""The replica side of the gateway protocol: the load report
(loadreport.py) and request deadlines (limiter.py), the port's own copies
of what a replica needs from the JAX package's gateway."""
