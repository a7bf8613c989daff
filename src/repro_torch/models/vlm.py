"""InternVL2-26b backbone (port of ``repro.models.vlm``): an InternLM2-style
dense LM with a ViT frontend stub (the batch carries precomputed patch
embeddings ``image_embeds``). Everything else is the dense transformer; the
VLM specifics (the image embeddings prepended, so that positions and the KV
cache count them, and the text-only loss tail) live in
``transformer.embed_tokens`` and ``loss_fn`` behind ``cfg.family == "vlm"``.
The family serves; its training (``loss_fn`` here, with image embeddings from
the data pipeline) waits for a later slice.
"""

from repro_torch.models.transformer import (decode_step, init_cache,
                                            init_params, prefill)

__all__ = ["init_params", "init_cache", "prefill", "decode_step"]
