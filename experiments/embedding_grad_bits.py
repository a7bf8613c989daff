"""Does the embedding's gradient differ in bits between the two lookups the
port uses? The unsharded models index the table (``table[tokens]``, whose
backward is an accumulating index-put); the sharded ones call
``F.embedding`` (whose vocab split DTensor supports), whose backward is
another CUDA kernel. At qwen3-1.7b's table (151,936 x 2,048, bf16) and one
training microbatch's tokens (4 x 2,048 from ``data.host_batch``), on a
CUDA device: each gradient twice, and the two against each other.

    python experiments/embedding_grad_bits.py      # from the repo root, on a GPU
"""
import sys, json, torch, torch.nn.functional as F
sys.path.insert(0, "src")
from repro_torch import configs
from repro_torch.data import DataConfig, host_batch
cfg = configs.get("qwen3-1.7b")
tab = (torch.randn(cfg.vocab, cfg.d_model, device="cuda", generator=torch.Generator("cuda").manual_seed(0)) * 0.02).bfloat16()
tok = torch.from_numpy(host_batch(DataConfig(vocab=cfg.vocab, seq_len=2048, global_batch=8), 1, 0, 1)["tokens"][:4]).cuda()
g = torch.randn(4, 2048, cfg.d_model, device="cuda", generator=torch.Generator("cuda").manual_seed(1)).bfloat16()
def grad(f):
    t = tab.detach().requires_grad_()
    f(t).backward(g)
    return t.grad
out = {}
a1, a2 = grad(lambda t: t[tok]), grad(lambda t: t[tok])
b1, b2 = grad(lambda t: F.embedding(tok, t)), grad(lambda t: F.embedding(tok, t))
out["index_repeats_bitwise"] = bool(torch.equal(a1, a2))
out["embedding_repeats_bitwise"] = bool(torch.equal(b1, b2))
out["index_vs_embedding_bitwise"] = bool(torch.equal(a1, b1))
out["index_vs_embedding_max_abs"] = float((a1.float() - b1.float()).abs().max())
out["rows_differing"] = int((a1 != b1).any(-1).sum())
print(json.dumps({"diag_embed": out}))
