"""host_dispatch_ms.stream: median host ms from dispatch to return of the
detect call (the benchmark's own span around CapturedDetect.__call__)."""

from benchmark.lib.readers import host_dispatch_ms as read  # noqa: F401
