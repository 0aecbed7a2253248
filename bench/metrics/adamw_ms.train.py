"""Milliseconds of ``adamw.apply_updates`` by CUDA events around it, the
mean over the window's steps."""


def read(rec):
    if not rec.adamw_ms:
        return None
    return sum(rec.adamw_ms) / len(rec.adamw_ms)
