from gpz_tpu.ops.ozaki import ozaki_gram, ozaki_tn

__all__ = ["ozaki_gram", "ozaki_tn"]
