"""Utilities of the port: the metrics registry, task spawning and log
formatting that the crypto sidecar uses."""
