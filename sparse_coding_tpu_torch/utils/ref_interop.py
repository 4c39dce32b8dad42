"""Reference-artifact interop (the JAX package's
``utils/ref_interop.py``): read and write the HoagyC/sparse_coding
artifacts.

- ``learned_dicts.pt``: a torch pickle of ``[(LearnedDict, hyperparams),
  …]`` whose classes live in the reference's ``autoencoders.*`` modules,
  which are not installed here. ``load_reference_learned_dicts``
  unpickles them into attribute-only shim objects through an allowlisted
  unpickler (deny by default: any other global refuses to load, before
  anything runs) and converts each to the port's :class:`LearnedDict`;
  ``export_reference_learned_dicts`` writes the port's dicts back in the
  reference's layout.
- ``<i>.pt`` activation chunks: one torch-saved ``[n, d]`` fp16 tensor a
  file. :class:`~sparse_coding_tpu_torch.data.chunk_store.ChunkStore`
  reads such folders directly (``format="pt"``);
  ``import_reference_chunks`` converts one to the ``.npy`` store when
  read throughput matters.

Known parity deviations (all from the row normalization of exported
dictionaries, ``models/learned_dict.py::normalize_rows``), the JAX
package's too:

- reference ``RandomDict`` decodes with its RAW gaussian rows; the
  converted dict normalizes. Feature *directions* (MMCS, cosine
  geometry) are identical.
- reference ``TiedSAE(norm_encoder=False)`` encodes with raw rows; that
  case converts to :class:`UntiedSAE` (raw encoder, normalized decoder),
  which reproduces it exactly.
- reference ``ReverseSAE`` defaults to ``norm_encoder=False`` and its
  decode mutates the code tensor in place; the converted
  :class:`ReverseSAE` is the pure normalized-row variant.
- the export side has the mirror-image deviation: a ReverseSAE exports as
  a reference ``ReverseSAE(norm_encoder=True)``, but the reference's own
  decode einsums the dict transposed — right only for square
  dictionaries — and mutates its input codes in place, so reference-side
  decode/predict of an exported non-square ReverseSAE will not reproduce
  this decode. Encode (what every reference eval script uses) matches.
  When reference-side decode matters, export the dict as a plain TiedSAE
  (the same encode, the standard decode).
"""

from __future__ import annotations

import io
import json
import pickle
import sys
import types
from pathlib import Path
from typing import Any

import numpy as np
import torch

from sparse_coding_tpu_torch.resilience.atomic import (
    atomic_save_npy,
    atomic_write_text,
)

_REF_MODULE_PREFIXES = ("autoencoders", "torchtyping", "test_datasets")


class _RefShim:
    """Stand-in for a reference class while unpickling: an instance
    carries only the pickled ``__dict__`` (the reference's classes are
    plain Python objects, pickled as class + attribute dict)."""

    def __init__(self, *args, **kwargs):  # tolerate NEWOBJ with args
        pass


_shim_cache: dict[tuple[str, str], type] = {}


def _shim_class(module: str, name: str) -> type:
    key = (module, name)
    if key not in _shim_cache:
        _shim_cache[key] = type(name, (_RefShim,), {"__module__": module})
    return _shim_cache[key]


# The only non-shim globals a reference learned_dicts.pt may name: the
# tensor-rebuild machinery, container and scalar plumbing, and numpy
# array reconstruction (hyperparams may carry numpy values). Any global
# of a pickle's reduce chain runs at load, so find_class denies
# everything else — torch.storage._load_from_bytes included: it unpickles
# its argument with unrestricted pickle, and neither torch.save format
# names it.
_ALLOWED_GLOBALS: dict[str, frozenset[str]] = {
    "collections": frozenset({"OrderedDict", "defaultdict"}),
    "builtins": frozenset({
        "list", "tuple", "dict", "set", "frozenset", "bytearray",
        "int", "float", "bool", "complex", "str", "bytes", "slice",
        "range", "NoneType",
    }),
    "copyreg": frozenset({"_reconstructor"}),
    "numpy": frozenset({
        "ndarray", "dtype", "bool_", "int8", "int16", "int32", "int64",
        "uint8", "uint16", "uint32", "uint64", "float16", "float32",
        "float64", "complex64", "complex128", "longlong", "ulonglong",
    }),
    "numpy.core.multiarray": frozenset({"_reconstruct", "scalar"}),
    "numpy._core.multiarray": frozenset({"_reconstruct", "scalar"}),
    "torch": frozenset({
        "Size", "device", "dtype", "ByteStorage", "DoubleStorage",
        "FloatStorage", "HalfStorage", "LongStorage", "IntStorage",
        "ShortStorage", "CharStorage", "BoolStorage", "BFloat16Storage",
    }),
    "torch.storage": frozenset({"TypedStorage", "UntypedStorage"}),
    "torch.serialization": frozenset({"_get_layout"}),
}

# Name-prefix rules for modules whose helpers change across versions:
# torch._utils' tensor-rebuild family all share the _rebuild_ prefix.
_ALLOWED_PREFIXES: dict[str, str] = {"torch._utils": "_rebuild_"}


class _RefUnpickler(pickle.Unpickler):
    """Reference-package globals resolve to shims; the torch, numpy and
    container helpers resolve from the allowlist; everything else is
    refused."""

    def find_class(self, module: str, name: str):
        if module.split(".")[0] in _REF_MODULE_PREFIXES:
            return _shim_class(module, name)
        prefix = _ALLOWED_PREFIXES.get(module)
        allowed_here = (name in _ALLOWED_GLOBALS.get(module, frozenset())
                        or (prefix is not None and name.startswith(prefix)))
        if not allowed_here:
            raise pickle.UnpicklingError(
                f"refusing to unpickle global {module}.{name}: not in the "
                "reference-artifact allowlist (utils/ref_interop.py "
                "_ALLOWED_GLOBALS). If this is a legitimate reference "
                "artifact, extend the allowlist deliberately.")
        return super().find_class(module, name)


def _restricted_load(fh, **kwargs):
    return _RefUnpickler(fh, **kwargs).load()


def _restricted_loads(data, **kwargs):
    return _RefUnpickler(io.BytesIO(data), **kwargs).load()


class _RefPickleModule:
    """Duck-typed ``pickle_module`` for ``torch.load``: every load surface
    goes through the allowlisted unpickler (torch's legacy format feeds
    header pickles through ``load``/``loads``)."""

    Unpickler = _RefUnpickler
    load = staticmethod(_restricted_load)
    loads = staticmethod(_restricted_loads)
    dump = staticmethod(pickle.dump)
    dumps = staticmethod(pickle.dumps)
    HIGHEST_PROTOCOL = pickle.HIGHEST_PROTOCOL


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().float().numpy()
    return np.asarray(v, dtype=np.float32)


def _t(v) -> torch.Tensor:
    """A float32 CPU tensor that owns its memory."""
    return torch.from_numpy(np.array(_np(v), dtype=np.float32))


def _nontrivial(v, identity: np.ndarray):
    """None when a centering buffer is missing or its do-nothing value."""
    if v is None:
        return None
    arr = _np(v)
    if arr.shape == identity.shape and np.allclose(arr, identity):
        return None
    return arr


def _convert_one(obj: Any):
    """Shim object (reference class name + attrs) → the port's
    LearnedDict."""
    from sparse_coding_tpu_torch.models.learned_dict import (
        AddedNoise,
        Identity,
        IdentityPositive,
        IdentityReLU,
        RandomDict,
        ReverseSAE,
        Rotation,
        TiedSAE,
        TopKLearnedDict,
        UntiedSAE,
    )

    name = type(obj).__name__
    d = obj.__dict__

    if name == "Identity":
        return Identity.create(int(d["activation_size"]))
    if name == "IdentityReLU":
        bias = d.get("bias")
        if bias is not None and np.any(_np(bias)):
            raise NotImplementedError(
                "reference IdentityReLU with a non-zero bias has no "
                "counterpart (the reference constructor cannot set one "
                "either — `if bias:` on a tensor raises)")
        return IdentityReLU.create(int(d["activation_size"]))
    if name == "IdentityPositive":
        return IdentityPositive.create(int(d["activation_size"]))
    if name == "RandomDict":
        return RandomDict(dictionary=_t(d["encoder"]))
    if name == "Rotation":
        return Rotation(rotation=_t(d["matrix"]))
    if name == "AddedNoise":
        dim = int(d["activation_size"])
        # the key of jax.random.PRNGKey(0), as the JAX converter uses
        return AddedNoise(noise_mag=torch.tensor(float(_np(d["noise_mag"]))),
                          eye=torch.eye(dim),
                          key=torch.zeros(2, dtype=torch.uint32))
    if name == "UntiedSAE":
        return UntiedSAE(encoder=_t(d["encoder"]),
                         encoder_bias=_t(d["encoder_bias"]),
                         dictionary=_t(d["decoder"]))
    if name in ("TiedSAE", "TiedCenteredSAE"):
        enc, bias = _t(d["encoder"]), _t(d["encoder_bias"])
        dim = enc.shape[-1]
        rot = _nontrivial(d.get("center_rot"), np.eye(dim, dtype=np.float32))
        trans = _nontrivial(d.get("center_trans"),
                            np.zeros(dim, dtype=np.float32))
        scale = _nontrivial(d.get("center_scale"),
                            np.ones(dim, dtype=np.float32))
        if not d.get("norm_encoder", True):
            if rot is not None or trans is not None or scale is not None:
                raise NotImplementedError(
                    "reference TiedSAE with norm_encoder=False AND a "
                    "non-trivial centering transform is not representable")
            # raw-row encode + normalized decode ≡ UntiedSAE
            return UntiedSAE(encoder=enc, encoder_bias=bias, dictionary=enc)
        opt = lambda a: None if a is None else _t(a)
        return TiedSAE(dictionary=enc, encoder_bias=bias,
                       centering_rot=opt(rot), centering_trans=opt(trans),
                       centering_scale=opt(scale))
    if name == "ReverseSAE":
        return ReverseSAE(dictionary=_t(d["encoder"]),
                          encoder_bias=_t(d["encoder_bias"]))
    if name == "TopKLearnedDict":
        return TopKLearnedDict(dictionary=_t(d["dict"]), k=int(d["sparsity"]))
    if name in ("TiedPositiveSAE", "UntiedPositiveSAE"):
        # encode uses the RAW |encoder| rows (the constructor stored
        # |encoder|); decode is the row-normalized encoder in both: an
        # UntiedSAE(enc, bias, enc). The norm_encoder=True tied case is a
        # plain TiedSAE.
        enc, bias = _t(d["encoder"]), _t(d["encoder_bias"])
        if name == "TiedPositiveSAE" and d.get("norm_encoder", False):
            return TiedSAE(dictionary=enc, encoder_bias=bias)
        return UntiedSAE(encoder=enc, encoder_bias=bias, dictionary=enc)
    if name == "LISTADenoisingSAE":
        from sparse_coding_tpu_torch.models.lista import LISTADenoisingSAE

        p = d["params"]
        return LISTADenoisingSAE(
            decoder=_t(p["decoder"]),
            encoder_layers=_stack_layer_list(p["encoder_layers"]))
    if name == "ResidualDenoisingSAE":
        from sparse_coding_tpu_torch.models.lista import ResidualDenoisingSAE

        p = d["params"]
        # the reference's constructor reads params["dict"] though its init
        # writes "decoder": accept either key
        return ResidualDenoisingSAE(
            decoder=_t(p.get("decoder", p.get("dict"))),
            encoder_layers=_stack_layer_list(p["encoder_layers"]),
            encoder_bias=_t(p["encoder_bias"]))

    raise NotImplementedError(
        f"no conversion for reference class {name!r} "
        f"(attrs: {sorted(d)}); supported: Identity, IdentityReLU, "
        "IdentityPositive, RandomDict, Rotation, AddedNoise, UntiedSAE, "
        "TiedSAE, TiedCenteredSAE, ReverseSAE, TopKLearnedDict, "
        "TiedPositiveSAE, UntiedPositiveSAE, LISTADenoisingSAE, "
        "ResidualDenoisingSAE")


def _stack_layer_list(layers) -> dict:
    """The reference's list of per-layer param dicts → the stacked
    ``[L, ...]`` dict (``models/lista.py``)."""
    if not layers:
        raise NotImplementedError(
            "reference artifact has an empty encoder_layers list "
            "(n_hidden_layers=0); the stacked LISTA format needs at least "
            "one layer")
    return {k: torch.stack([_t(layer[k]) for layer in layers])
            for k in layers[0]}


def _clean_value(v):
    """A hyperparam leaf as plain Python or numpy, recursing into
    containers: the export side pickles these for an environment that
    may lack this package; the load side uses the same coercion."""
    if isinstance(v, (bool, int, float, str, type(None))):
        return v  # bool and int must not round-trip through float32
    if isinstance(v, dict):
        return {k: _clean_value(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        out = [_clean_value(x) for x in v]
        return tuple(out) if isinstance(v, tuple) else out
    try:
        arr = _np(v)
        return arr.item() if arr.size == 1 else arr
    except (TypeError, ValueError):
        return v


def _clean_hyperparams(h: Any) -> dict:
    if not isinstance(h, dict):
        return {"hyperparams": _clean_value(h)}
    return {k: _clean_value(v) for k, v in h.items()}


def load_reference_learned_dicts(path: str | Path,
                                 device="cpu") -> list[tuple[Any, dict]]:
    """A reference ``learned_dicts.pt`` as ``[(LearnedDict, hyperparams),
    …]``, the tuple contract of ``utils.artifacts.load_learned_dicts``,
    with every tensor on ``device``."""
    raw = torch.load(str(path), map_location="cpu",
                     pickle_module=_RefPickleModule, weights_only=False)
    if not isinstance(raw, (list, tuple)):
        raise ValueError(f"{path}: expected a list of (dict, hyperparams) "
                         f"tuples, got {type(raw).__name__}")
    out = []
    for item in raw:
        obj, hyper = item if isinstance(item, (list, tuple)) else (item, {})
        out.append((_convert_one(obj).to(device), _clean_hyperparams(hyper)))
    return out


def export_reference_learned_dicts(pairs, path: str | Path) -> None:
    """Save the port's dicts as a reference ``learned_dicts.pt`` that the
    reference's own tooling can ``torch.load``.

    The pickle names ``autoencoders.*`` classes, resolved when the
    reference loads it; writing needs no reference package (shim classes
    are registered for the duration of the save, and any real class they
    shadow is put back). Exportable: UntiedSAE, TiedSAE (with an optional
    centering; TiedCenteredSAE too), ReverseSAE, TopKLearnedDict, in the
    reference constructors' layouts. ReverseSAE matches the reference on
    encode only (see the module docstring)."""
    from sparse_coding_tpu_torch.models.learned_dict import (
        ReverseSAE,
        TiedSAE,
        TopKLearnedDict,
        UntiedSAE,
    )

    def convert(ld):
        if isinstance(ld, UntiedSAE):
            obj = _shim_class("autoencoders.learned_dict", "UntiedSAE")()
            obj.__dict__.update(encoder=_t(ld.encoder),
                                decoder=_t(ld.dictionary),
                                encoder_bias=_t(ld.encoder_bias))
        elif isinstance(ld, ReverseSAE):
            obj = _shim_class("autoencoders.learned_dict", "ReverseSAE")()
            obj.__dict__.update(encoder=_t(ld.dictionary),
                                encoder_bias=_t(ld.encoder_bias),
                                norm_encoder=True)
        elif isinstance(ld, TiedSAE):
            dim = ld.dictionary.shape[-1]
            opt = lambda v, default: _t(v) if v is not None else default
            obj = _shim_class("autoencoders.learned_dict", "TiedSAE")()
            obj.__dict__.update(
                encoder=_t(ld.dictionary), encoder_bias=_t(ld.encoder_bias),
                norm_encoder=True,
                center_trans=opt(ld.centering_trans, torch.zeros(dim)),
                center_rot=opt(ld.centering_rot, torch.eye(dim)),
                center_scale=opt(ld.centering_scale, torch.ones(dim)))
        elif isinstance(ld, TopKLearnedDict):
            obj = _shim_class("autoencoders.topk_encoder",
                              "TopKLearnedDict")()
            obj.__dict__.update(dict=_t(ld.get_learned_dict()),
                                sparsity=int(ld.k))
        else:
            raise NotImplementedError(
                f"no reference-format export for {type(ld).__name__}; "
                "exportable: UntiedSAE, TiedSAE, ReverseSAE, "
                "TopKLearnedDict")
        obj.__dict__.update(n_feats=int(ld.n_feats),
                            activation_size=int(ld.activation_size))
        return obj

    records = [(convert(ld), _clean_hyperparams(dict(hyper)))
               for ld, hyper in pairs]
    # pickle writes class references by qualified name: register only the
    # shims these records use, keep whatever they would shadow, and put
    # everything back afterwards
    used = {type(obj) for obj, _ in records}
    sentinel = object()
    created_modules: list[str] = []
    shadowed: list[tuple] = []  # (module object, attribute, prior value)
    try:
        pkg = sys.modules.get("autoencoders")
        if pkg is None:
            pkg = types.ModuleType("autoencoders")
            sys.modules["autoencoders"] = pkg
            created_modules.append("autoencoders")
        for cls in used:
            module = cls.__module__  # "autoencoders.<sub>"
            mod = sys.modules.get(module)
            if mod is None:
                mod = types.ModuleType(module)
                sys.modules[module] = mod
                created_modules.append(module)
            shadowed.append((mod, cls.__name__,
                             getattr(mod, cls.__name__, sentinel)))
            setattr(mod, cls.__name__, cls)
            sub = module.split(".", 1)[1]
            shadowed.append((pkg, sub, getattr(pkg, sub, sentinel)))
            setattr(pkg, sub, mod)
        torch.save(records, str(path))
    finally:
        for mod, attr, prior in reversed(shadowed):
            if prior is sentinel:
                if hasattr(mod, attr):
                    delattr(mod, attr)
            else:
                setattr(mod, attr, prior)
        for module in created_modules:
            sys.modules.pop(module, None)


def read_pt_chunk(path: str | Path, dtype=np.float32) -> np.ndarray:
    """One reference activation chunk (a torch-saved [n, ...] tensor) as
    a numpy [n, d] array."""
    t = torch.load(str(path), map_location="cpu", weights_only=True)
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{path}: expected a tensor, got {type(t).__name__}")
    return t.numpy().astype(dtype, copy=False).reshape(t.shape[0], -1)


def import_reference_chunks(src: str | Path, dst: str | Path,
                            dtype: str = "float16") -> int:
    """Convert a reference chunk folder (``0.pt, 1.pt, …``) into a ``.npy``
    ChunkStore at ``dst``, chunk for chunk (so chunk cursors keep their
    meaning). Returns the number of chunks written."""
    src, dst = Path(src), Path(dst)
    paths = sorted((p for p in src.glob("*.pt") if p.stem.isdigit()),
                   key=lambda p: int(p.stem))
    if not paths:
        raise FileNotFoundError(f"no <i>.pt chunks in {src}")
    dst.mkdir(parents=True, exist_ok=True)
    np_dtype = np.dtype(dtype)
    dim = None
    for i, p in enumerate(paths):
        arr = read_pt_chunk(p, dtype=np_dtype)
        dim = arr.shape[-1] if dim is None else dim
        atomic_save_npy(dst / f"{i}.npy", arr)
    meta = {"activation_dim": int(dim), "dtype": str(np_dtype),
            "n_chunks": len(paths), "centered": False,
            "source": str(src), "format": "pt-import"}
    # meta.json last: its presence certifies a complete store
    atomic_write_text(dst / "meta.json", json.dumps(meta, indent=2))
    return len(paths)
