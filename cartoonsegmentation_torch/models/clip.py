"""The CLIP text tower and its BPE tokenizer (the port's own copy of what
the JAX package takes from ``transformers`` and
``models/ldm_inpaint.py``).

``ClipTextModel`` is transformers' CLIPTextModel under its
``text_model.*`` keys: token and position embeddings, pre-LN blocks
with a causal mask, ``final_layer_norm``; ``forward`` returns the
last hidden state. Two settings, as the JAX package builds them:
``SD2_TEXT`` (Marigold's: 23 layers, width 1024, 16 heads, gelu) and
``SD15_TEXT`` (SD1.5 inpainting's: 12 layers, width 768, 12 heads,
quick_gelu). ``clip_text_embed`` loads a state dict into a tower and
embeds token ids once, refusing a state dict that matches under 90% of
the tower's tensors. ``ClipTokenizer`` reads a checkpoint's
tokenizer/vocab.json and merges.txt.
"""
from __future__ import annotations

import json
from typing import List, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .ldm import init_random_

VOCAB = 49408
CONTEXT = 77
SD2_TEXT = dict(hidden=1024, num_layers=23, heads=16, act='gelu')
SD15_TEXT = dict(hidden=768, num_layers=12, heads=12, act='quick_gelu')


class _Attention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.k_proj = nn.Linear(hidden, hidden)
        self.v_proj = nn.Linear(hidden, hidden)
        self.q_proj = nn.Linear(hidden, hidden)
        self.out_proj = nn.Linear(hidden, hidden)

    def forward(self, x):
        B, L, C = x.shape
        q, k, v = (p(x).reshape(B, L, self.heads, -1).transpose(1, 2)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return self.out_proj(out.transpose(1, 2).reshape(B, L, C))


class _MLP(nn.Module):
    def __init__(self, hidden: int, act: str):
        super().__init__()
        self.act = act
        self.fc1 = nn.Linear(hidden, hidden * 4)
        self.fc2 = nn.Linear(hidden * 4, hidden)

    def forward(self, x):
        h = self.fc1(x)
        h = h * torch.sigmoid(1.702 * h) if self.act == 'quick_gelu' \
            else F.gelu(h)
        return self.fc2(h)


class _Layer(nn.Module):
    def __init__(self, hidden: int, heads: int, act: str):
        super().__init__()
        self.self_attn = _Attention(hidden, heads)
        self.layer_norm1 = nn.LayerNorm(hidden)
        self.mlp = _MLP(hidden, act)
        self.layer_norm2 = nn.LayerNorm(hidden)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.token_embedding = nn.Embedding(VOCAB, hidden)
        self.position_embedding = nn.Embedding(CONTEXT, hidden)

    def forward(self, ids):
        pos = torch.arange(ids.shape[1], device=ids.device)
        return self.token_embedding(ids) + self.position_embedding(pos)[None]


class _Encoder(nn.Module):
    def __init__(self, hidden: int, num_layers: int, heads: int, act: str):
        super().__init__()
        self.layers = nn.ModuleList([_Layer(hidden, heads, act)
                                     for _ in range(num_layers)])


class _TextTransformer(nn.Module):
    def __init__(self, hidden: int, num_layers: int, heads: int, act: str):
        super().__init__()
        self.embeddings = _Embeddings(hidden)
        self.encoder = _Encoder(hidden, num_layers, heads, act)
        self.final_layer_norm = nn.LayerNorm(hidden)

    def forward(self, ids):
        h = self.embeddings(ids)
        for layer in self.encoder.layers:
            h = layer(h)
        return self.final_layer_norm(h)


class ClipTextModel(nn.Module):
    """transformers' CLIPTextModel (keys ``text_model.*``); ``forward(ids
    (B, L) int64)`` → last_hidden_state (B, L, hidden)."""

    def __init__(self, hidden: int = 768, num_layers: int = 12,
                 heads: int = 12, act: str = 'quick_gelu'):
        super().__init__()
        if act not in ('gelu', 'quick_gelu'):
            raise ValueError(f'unknown CLIP activation {act!r}')
        self.text_model = _TextTransformer(hidden, num_layers, heads, act)

    def forward(self, ids):
        return self.text_model(ids)


def load_clip_text(model: ClipTextModel, text_sd: Mapping) -> None:
    """Load a CLIP text state dict (``text_model.*`` or bare keys) into
    ``model``; raise when it matches under 90% of the tower's tensors
    (a wrong key schema would leave the prompt embedding random)."""
    sd = {k[len('text_model.'):] if k.startswith('text_model.') else k:
          v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
          for k, v in text_sd.items()}
    res = model.text_model.load_state_dict(sd, strict=False)
    n_own = len(model.text_model.state_dict())
    n_loaded = n_own - len(res.missing_keys)
    if n_loaded < 0.9 * n_own:
        raise ValueError(
            f'CLIP text state dict matched only {n_loaded}/{n_own} tensors '
            '— wrong key schema (expected text_model.* / bare CLIPTextModel '
            'keys); prompt embeddings would come from random init. '
            f'Unexpected: {res.unexpected_keys[:3]}')


@torch.inference_mode()
def clip_text_embed(text_sd: Mapping, token_ids: Sequence[int],
                    hidden: int = 768, num_layers: int = 12, heads: int = 12,
                    act: str = 'quick_gelu', device='cpu') -> torch.Tensor:
    """A CLIP text tower loaded from ``text_sd`` run once on ``token_ids``
    on ``device`` → (1, L, hidden) last_hidden_state there. Tensors the
    state dict lacks keep a random init from seed 0."""
    with torch.device('meta'):
        model = ClipTextModel(hidden, num_layers, heads, act)
    model.to_empty(device=device)
    init_random_(model, torch.Generator(device).manual_seed(0))
    load_clip_text(model, text_sd)
    ids = torch.tensor([list(token_ids)], device=device)
    return model.eval()(ids)


# -- CLIP BPE tokenizer -------------------------------------------------

def _bytes_to_unicode():
    bs = list(range(ord('!'), ord('~') + 1)) + \
        list(range(ord('¡'), ord('¬') + 1)) + \
        list(range(ord('®'), ord('ÿ') + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class ClipTokenizer:
    """Minimal CLIP BPE tokenizer (openai/CLIP simple_tokenizer
    semantics) built from a checkpoint's tokenizer/vocab.json +
    merges.txt."""

    def __init__(self, vocab_path: str, merges_path: str):
        import re
        with open(vocab_path, encoding='utf8') as f:
            self.encoder = json.load(f)
        with open(merges_path, encoding='utf8') as f:
            merges = f.read().split('\n')
        merges = [tuple(m.split()) for m in merges
                  if m and not m.startswith('#') and len(m.split()) == 2]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = _bytes_to_unicode()
        # CLIP's pattern uses \p{L}/\p{N} (regex module); the ASCII
        # classes below are equivalent for the English prompts this
        # pipeline builds
        self.pat = re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
            r"|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+", re.IGNORECASE)
        self.bos = self.encoder.get('<|startoftext|>', 49406)
        self.eos = self.encoder.get('<|endoftext|>', 49407)

    def _bpe(self, token: str) -> List[str]:
        # CLIP convention: the last character carries the </w> marker
        word = tuple(token[:-1]) + (token[-1] + '</w>',)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            pair = min(pairs,
                       key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if pair not in self.bpe_ranks:
                break
            a, b = pair
            out = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a \
                        and word[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = tuple(out)
        return list(word)

    def encode(self, text: str, context_len: int = 77) -> List[int]:
        import re
        text = re.sub(r'\s+', ' ', text.strip()).lower()
        ids = [self.bos]
        for tok in self.pat.findall(text):
            tok = ''.join(self.byte_encoder[b]
                          for b in tok.encode('utf-8'))
            for piece in self._bpe(tok):
                if piece in self.encoder:
                    ids.append(self.encoder[piece])
        ids = ids[:context_len - 1] + [self.eos]
        ids = ids + [self.eos] * (context_len - len(ids))
        return ids
