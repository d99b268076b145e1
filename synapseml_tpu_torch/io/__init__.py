"""I/O helpers of the port: image decoding and the retrying HTTP client the
model repositories use."""
