"""Device ms a step of the cuFFT kernels (their names hold "fft"), the
plain PME's forward and inverse transforms."""


def read(trace):
    s, n = trace.device_s(lambda name: "fft" in name.lower())
    return s * 1e3 / trace.steps if n else None
