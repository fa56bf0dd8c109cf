"""Local chat client: the decoder runtime behind the chat interface, in
PyTorch on the card.

The port's counterpart of ``youtu_rag_tpu/agents/local_llm.py``.
``provider: local`` serves a causal-LM checkpoint (``models/decoder.py``)
in-process, with the same ``chat`` / ``stream_chat`` surface as the remote
clients and no network. Tool calling composes through ``ReactChatClient``
(tools as text), as the reference adapts models without native function
calling.

Serving, as in the JAX package:
- the matmul weights are stored in bf16 (``cast_params_for_serving``);
- prompts left-pad into power-of-two length buckets and ``max_new_tokens``
  rounds up to a power of two, clamped to half the checkpoint's
  ``max_len``; a prompt past the rest keeps its most recent tokens;
- one ``generate`` per chat (prefill, then a host loop of decode steps);
- an ``asyncio.Lock`` serializes the device across concurrent chats;
- stop strings cut the text; ``stream_chat`` re-emits it in 48-character
  deltas.

Chat templates: "plain" (role-tagged lines, the in-repo trainer's format),
"chatml" (``<|im_start|>``, qwen-style), "llama" (``[INST]``); detected
from the tokenizer's special tokens unless one is given.
"""

from __future__ import annotations

import asyncio
from pathlib import Path
from typing import Any

import torch

from ..utils.device import resolve_device
from ..utils.log import get_logger
from .llm import BaseChatClient, ChatMessage, ChatResponse, StreamDelta, Usage

logger = get_logger("agents.local_llm")


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b <<= 1
    return b


def render_chat(messages: list[ChatMessage], template: str) -> str:
    """Messages → one prompt string ending with the assistant cue."""
    if template == "chatml":
        parts = [f"<|im_start|>{m.role}\n{m.content or ''}<|im_end|>" for m in messages]
        return "\n".join(parts) + "\n<|im_start|>assistant\n"
    if template == "llama":
        sys = "\n".join(m.content or "" for m in messages if m.role == "system")
        out = ""
        for m in messages:
            if m.role == "user":
                body = (f"<<SYS>>\n{sys}\n<</SYS>>\n\n{m.content}" if sys else m.content) or ""
                sys = ""  # the system text folds into the first user turn only
                out += f"[INST] {body} [/INST]"
            elif m.role == "assistant":
                out += f" {m.content or ''} "
        return out
    # "plain": role-tagged lines, the trainer's format
    lines = [f"{m.role}: {m.content or ''}" for m in messages]
    return "\n".join(lines) + "\nassistant:"


class LocalChatClient(BaseChatClient):
    """Serve a causal-LM checkpoint through the chat-client interface, on
    ``device`` (None: the CUDA card; a host without one raises)."""

    def __init__(
        self,
        weights_dir: str | Path | None = None,
        *,
        params: Any = None,
        cfg: Any = None,
        tokenizer: Any = None,
        template: str | None = None,
        max_new_tokens: int = 256,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        stop: list[str] | None = None,
        seed: int = 0,
        device: str | torch.device | None = None,
    ):
        from ..models.convert import decoder_params_from_numpy
        from ..models.decoder import cast_params_for_serving

        self.device = resolve_device(device)
        if weights_dir is not None:
            from ..models.bpe import BPETokenizer
            from ..models.pretrained import load_pretrained_decoder

            tree, cfg = load_pretrained_decoder(weights_dir)
            params = decoder_params_from_numpy(tree, cfg, self.device)
            tokenizer = BPETokenizer.from_dir(weights_dir)
        if params is None or cfg is None or tokenizer is None:
            raise ValueError("LocalChatClient needs weights_dir or (params, cfg, tokenizer)")
        # decode reads every weight once a step: serve the matmul weights in bf16
        self.params = cast_params_for_serving(_to_device(params, self.device))
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.stop = list(stop or [])
        self.template = template or self._detect_template()
        self._lock = asyncio.Lock()
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self.model = "local"

    def _detect_template(self) -> str:
        added = getattr(self.tokenizer, "added", {}) or {}
        if "<|im_start|>" in added:
            return "chatml"
        if getattr(self.tokenizer, "bos_token", None) == "<s>":
            return "llama"
        return "plain"

    # ------------------------------------------------------------- generate

    def _generate_sync(self, prompt_text: str, max_new: int,
                       temperature: float) -> tuple[str, int, int]:
        from ..models.decoder import generate, left_pad_batch

        ids = self.tokenizer.encode(prompt_text, add_bos=True)
        budget = self.cfg.max_len - max_new
        if budget <= 0:
            raise ValueError(f"max_new_tokens {max_new} leaves no prompt room at "
                             f"max_len {self.cfg.max_len}")
        if len(ids) > budget:
            ids = ids[-budget:]  # keep the most recent context
        toks, mask = left_pad_batch([ids], pad_id=self.cfg.eos_token_id)
        out, lengths = generate(
            self.params,
            torch.from_numpy(toks).to(self.device),
            torch.from_numpy(mask).to(self.device),
            self.cfg,
            max_new_tokens=max_new,
            temperature=temperature,
            top_k=self.top_k,
            top_p=self.top_p,
            generator=self._generator,
        )
        n = int(lengths[0])
        text = self.tokenizer.decode(out[0, :n].tolist())
        for s in self.stop:  # template end markers count as stop strings
            cut = text.find(s)
            if cut >= 0:
                text = text[:cut]
        return text.strip(), len(ids), n

    async def chat(self, messages, tools=None, **kwargs) -> ChatResponse:
        if tools:
            raise ValueError("LocalChatClient is text-only: wrap it in ReactChatClient "
                             "for tool calling (agents/react.py)")
        prompt = render_chat(messages, self.template)
        max_new = _bucket(int(kwargs.get("max_tokens") or self.max_new_tokens))
        # leave at least half of max_len for the prompt (small checkpoints
        # have a max_len below the 256-token default)
        while max_new > max(1, self.cfg.max_len // 2):
            max_new >>= 1
        temperature = float(self.temperature if kwargs.get("temperature") is None
                            else kwargs["temperature"])
        async with self._lock:
            text, n_in, n_out = await asyncio.to_thread(self._generate_sync, prompt, max_new,
                                                        temperature)
        usage = Usage(input_tokens=n_in, output_tokens=n_out)
        return ChatResponse(ChatMessage(role="assistant", content=text), usage=usage)

    async def stream_chat(self, messages, tools=None, **kwargs):
        """One generate, re-emitted as 48-character text deltas."""
        resp = await self.chat(messages, tools, **kwargs)
        text = resp.message.content or ""
        step = 48
        for i in range(0, len(text), step):
            yield StreamDelta("text_delta", text=text[i : i + step])
        yield StreamDelta("done", response=resp)


def _to_device(tree: dict, device: torch.device) -> dict:
    """A parameter dict (tensors or numpy arrays) on ``device``, dtypes kept."""
    return {k: _to_device(v, device) if isinstance(v, dict) else torch.as_tensor(v).to(device)
            for k, v in tree.items()}
