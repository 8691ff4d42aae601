"""Set-up seconds: from the interpreter's start to the window's, the
import of torch, the CUDA context, the scene, the tables, the kernels'
build or load and the warm-up included (host clock)."""


def read(r):
    return r.setup_s
