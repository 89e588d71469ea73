"""Device ms of the DiT scan's kernels (adaln_modulate, qk_norm_rope, the
GEMMs) per padded audio second, over the traced batches whose launches the
trace all kept."""


def read(run):
    from harness.serve import ms_per_padded_audio_s

    return ms_per_padded_audio_s(run, "scan")
