"""The DSP module library and catalog.

The catalog mirrors the reference's ``get_catalog()`` registry
(src/synth.rs:421-515): the same 14 creatable module names (Output is
created by the workspace, src/main.rs:129-132), plus the build-side
``Input`` driver module.
"""

from .base import CV_DTYPE, ModuleDef
from .oscillator import OSCILLATOR, NOISE
from .filter import MOOG_FILTER
from .adsr import ADSR
from .vca import VCA
from .mixer import MONO_MIXER
from .math import ADD, SUBTRACT, MULTIPLY, NON_LINEAR
from .sequencer import GRID_SEQUENCER, PATTERN_SEQUENCER
from .sample import SAMPLE
from .freeverb import FREEVERB
from .output import OUTPUT
from .input import INPUT

# Creatable module types, in the reference's catalog order
# (src/synth.rs:421-515), with Output and Input appended.
CATALOG: dict[str, ModuleDef] = {
    d.type_name: d
    for d in (
        OSCILLATOR,
        NOISE,
        GRID_SEQUENCER,
        PATTERN_SEQUENCER,
        ADSR,
        VCA,
        MOOG_FILTER,
        MONO_MIXER,
        SAMPLE,
        ADD,
        SUBTRACT,
        MULTIPLY,
        NON_LINEAR,
        FREEVERB,
        OUTPUT,
        INPUT,
    )
}

# Catalog entries present at import time; :func:`unregister` refuses to
# remove these (presets, the CLI and the .srk reader depend on them).
_BUILTIN_TYPES = frozenset(CATALOG)


def register(mdef: ModuleDef, *, replace: bool = False) -> ModuleDef:
    """Add a user-defined module type to the catalog.

    The JAX analogue of implementing the reference's ``SynthModule`` trait
    and appending to ``get_catalog()`` (src/synth.rs:216-263, 421-515):
    once registered, the type is creatable with ``Patch.add(name)``, runs
    on the scan engine unconditionally and on the block engine (stateless
    or ``block``-implementing modules run block-parallel; stateful ones
    join the serial stage), persists through ``io.patchfile`` JSON, and —
    when it declares ``register_safe=True`` — is traced into the fused
    whole-patch Pallas kernel like the built-ins.  See
    docs/MODULES.md "Writing your own module" for the contract.

    Returns ``mdef`` so it can be used as a decorator-style one-liner.
    """
    if not isinstance(mdef, ModuleDef):
        raise TypeError(f"expected a ModuleDef, got {type(mdef).__name__}")
    if not mdef.type_name or not isinstance(mdef.type_name, str):
        raise ValueError("ModuleDef.type_name must be a non-empty string")
    for attr in ("make", "num_inputs", "num_outputs", "input_labels",
                 "output_labels", "init_state", "step"):
        if not callable(getattr(mdef, attr, None)):
            raise ValueError(f"ModuleDef.{attr} must be callable")
    if mdef.type_name in _BUILTIN_TYPES:
        raise ValueError(
            f"cannot replace built-in module type {mdef.type_name!r}")
    if mdef.type_name in CATALOG and not replace:
        raise ValueError(
            f"module type {mdef.type_name!r} is already registered "
            "(pass replace=True to override a custom type)")
    CATALOG[mdef.type_name] = mdef
    return mdef


def unregister(type_name: str) -> None:
    """Remove a previously :func:`register`-ed custom module type."""
    if type_name in _BUILTIN_TYPES:
        raise ValueError(f"cannot unregister built-in type {type_name!r}")
    if type_name not in CATALOG:
        raise KeyError(f"module type {type_name!r} is not registered")
    del CATALOG[type_name]


__all__ = [
    "CATALOG",
    "CV_DTYPE",
    "ModuleDef",
    "register",
    "unregister",
    "OSCILLATOR",
    "NOISE",
    "MOOG_FILTER",
    "ADSR",
    "VCA",
    "MONO_MIXER",
    "ADD",
    "SUBTRACT",
    "MULTIPLY",
    "NON_LINEAR",
    "GRID_SEQUENCER",
    "PATTERN_SEQUENCER",
    "SAMPLE",
    "FREEVERB",
    "OUTPUT",
    "INPUT",
]
