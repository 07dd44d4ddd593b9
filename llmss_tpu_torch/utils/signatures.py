"""The executable-signature vocabulary (counterpart:
llmss_tpu/utils/signatures.py): one closed enum of kernel classes and one
formatting rule for signatures, so the cost table of ``utils/devtel.py``
and the compile events of graph captures render a signature as the same
``kind/part/part`` string. Standard library only.
"""

from __future__ import annotations

#: Every class a signature may name. The first four are the model-forward
#: classes devtel meters (series ``mfu_<class>`` / ``mbu_<class>``); the
#: rest name the state-management programs of the reference.
KERNEL_CLASSES = (
    "prefill",
    "decode",
    "decode_many",
    "decode_group",
    "ragged_group",
    "spec_group",
    "admit_merge",
    "seed",
    "import_blocks",
)

#: The subset devtel prices and exports MFU/MBU series for.
METERED_CLASSES = ("prefill", "decode", "decode_group", "ragged_group")


def signature(kind: str, *key) -> tuple:
    """The canonical signature ``(kind, *shape-key parts)``; ``kind`` must
    come from :data:`KERNEL_CLASSES` (a new family is added there)."""
    if kind not in KERNEL_CLASSES:
        raise ValueError(
            f"unknown kernel class {kind!r}; add it to "
            f"signatures.KERNEL_CLASSES (have: {', '.join(KERNEL_CLASSES)})"
        )
    return (kind, *key)


def signature_str(sig: tuple) -> str:
    """A signature as export keys and compile events name it: its parts
    joined by ``/`` (``decode_group/8/4/16/None``)."""
    return "/".join(str(p) for p in sig)
