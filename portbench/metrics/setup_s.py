"""setup_s: seconds from the process's start to the first timed request
(imports, CUDA context, the native and kernel libraries, the artifact,
the seeded inputs, warm-up and captures)."""


def read(rec):
    return rec.setup_s
