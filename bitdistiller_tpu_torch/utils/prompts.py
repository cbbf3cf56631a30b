"""Prompt templates for chat/instruction models (the port's own copy of the
JAX package's `utils/prompts.py`, string for string).

Parity with inference/utils/prompt_templates.py:11-251 (role-based templates
per model family) condensed to a registry of format functions.
"""

from __future__ import annotations

TEMPLATES = {
    "raw": lambda sys, user: user,
    "llama2": lambda sys, user: (
        f"[INST] <<SYS>>\n{sys}\n<</SYS>>\n\n{user} [/INST]"
        if sys
        else f"[INST] {user} [/INST]"
    ),
    "alpaca": lambda sys, user: (
        "Below is an instruction that describes a task. "
        "Write a response that appropriately completes the request.\n\n"
        f"### Instruction:\n{user}\n\n### Response:\n"
    ),
    "vicuna": lambda sys, user: (
        (sys or "A chat between a curious user and an artificial intelligence assistant.")
        + f" USER: {user} ASSISTANT:"
    ),
    "metamath": lambda sys, user: (
        "Below is an instruction that describes a task. "
        "Write a response that appropriately completes the request.\n\n"
        f"### Instruction:\n{user}\n\n### Response: Let's think step by step."
    ),
    "chatml": lambda sys, user: (
        (f"<|im_start|>system\n{sys}<|im_end|>\n" if sys else "")
        + f"<|im_start|>user\n{user}<|im_end|>\n<|im_start|>assistant\n"
    ),
    # falcon-instruct dialogue format (FalconPrompter, prompt_templates.py:174)
    "falcon": lambda sys, user: (
        (f"{sys}\n" if sys else "") + f"User: {user}\nAssistant:"
    ),
    # mpt-chat uses ChatML with mosaic's default system line
    # (MPTChatPrompter, prompt_templates.py:201)
    "mpt-chat": lambda sys, user: (
        "<|im_start|>system\n"
        + (sys or "A conversation between a user and an LLM-based AI assistant.")
        + "<|im_end|>\n"
        + f"<|im_start|>user\n{user}<|im_end|>\n<|im_start|>assistant\n"
    ),
    # wizardcoder-style code instruction (data_utils.py code prompt family)
    "code": lambda sys, user: (
        "Below is an instruction that describes a task. "
        "Write a response that appropriately completes the request.\n\n"
        f"### Instruction:\n{user}\n\n### Response:"
    ),
}


def render_prompt(template: str, user: str, system: str = "") -> str:
    if template not in TEMPLATES:
        raise ValueError(f"unknown template {template!r}; options: {sorted(TEMPLATES)}")
    return TEMPLATES[template](system, user)


def render_chat(template: str, messages: list) -> str:
    """Render an OpenAI-style message list [{role, content}, ...] into one
    prompt in the family's MULTI-TURN form, ending with the assistant-open
    marker. Families with a defined dialogue format (llama2, chatml,
    mpt-chat, vicuna, falcon) render turns in order with role markers;
    single-turn instruction formats (alpaca/metamath/code) and `raw` fold
    earlier turns into labeled history lines before the final user message.
    (The reference's prompt_templates.py keeps dialogue history the same
    way per family; the OpenAI endpoint routes through here so assistant
    turns are never misrendered into the user block.)"""
    if template not in TEMPLATES:
        raise ValueError(f"unknown template {template!r}; options: {sorted(TEMPLATES)}")
    system = "\n".join(
        m["content"] for m in messages if m["role"] == "system"
    )
    turns = [m for m in messages if m["role"] != "system"]
    if len(turns) == 1 and turns[0]["role"] == "user":
        user = turns[0]["content"]
        if template == "raw":  # raw keeps the system text (no markers exist)
            return f"{system}\n{user}" if system else user
        return render_prompt(template, user, system)

    if template in ("chatml", "mpt-chat"):
        if template == "mpt-chat" and not system:
            system = "A conversation between a user and an LLM-based AI assistant."
        out = f"<|im_start|>system\n{system}<|im_end|>\n" if system else ""
        for m in turns:
            out += f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n"
        return out + "<|im_start|>assistant\n"

    if template == "llama2":
        # [INST] u1 [/INST] a1 </s><s>[INST] u2 [/INST] — system folded
        # into the first user turn (the canonical llama-2 chat form)
        out, cur_user, pending_sys = [], None, system
        for m in turns:
            if m["role"] == "user":
                u = m["content"]
                if pending_sys:
                    u = f"<<SYS>>\n{pending_sys}\n<</SYS>>\n\n{u}"
                    pending_sys = ""
                cur_user = u if cur_user is None else f"{cur_user}\n{u}"
            else:
                out.append(f"[INST] {cur_user or ''} [/INST] {m['content']} </s><s>")
                cur_user = None
        return "".join(out) + f"[INST] {cur_user or ''} [/INST]"

    if template == "vicuna":
        out = (system or "A chat between a curious user and an artificial "
               "intelligence assistant.")
        for m in turns:
            if m["role"] == "user":
                out += f" USER: {m['content']}"
            else:
                out += f" ASSISTANT: {m['content']}</s>"
        return out + " ASSISTANT:"

    if template == "falcon":
        out = f"{system}\n" if system else ""
        for m in turns:
            role = "User" if m["role"] == "user" else "Assistant"
            out += f"{role}: {m['content']}\n"
        return out + "Assistant:"

    # raw + single-turn instruction templates: labeled history, then the
    # final user message through the template
    hist = turns[:-1] if turns and turns[-1]["role"] == "user" else turns
    last_user = turns[-1]["content"] if hist is not turns else ""
    lines = [f"{m['role']}: {m['content']}" for m in hist]
    folded = "\n".join(lines + ([f"user: {last_user}"] if lines and last_user else []))
    user = folded if lines else last_user
    if template == "raw":
        return (f"{system}\n{user}" if system else user) + "\nassistant:"
    return TEMPLATES[template](system, user)
