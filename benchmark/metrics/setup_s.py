"""Set-up seconds: from the process's start to the measured window's start
(imports, the scene, the kernels' build or load, warm-up units; on four
chips the ranks' start and the process group too)."""


def read(rec):
    return rec.setup_s
