"""Command-line entry points of the port (counterparts of ``repro.launch``'s
``train`` and ``serve``): a monitored job on one device that reports to a
monitoring stack reached over HTTP (``--lms-url``)."""
