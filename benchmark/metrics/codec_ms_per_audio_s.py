"""Device ms of the codec decoder's fp32 convolutions per padded audio second,
over the same batches."""


def read(run):
    from harness.serve import ms_per_padded_audio_s

    return ms_per_padded_audio_s(run, "codec_conv")
