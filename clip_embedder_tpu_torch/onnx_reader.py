"""Minimal from-scratch ONNX reader: weights and architecture from .onnx graphs.

Counterpart of ``clip_embedder_tpu.onnx_reader`` (its own copy: the port
imports nothing of the JAX package). The reference's model dirs ship their
weights inside ``visual.onnx``/``text.onnx`` (+ external ``.onnx.data``
blobs — reference: src/model_manager.rs:8-18). The ``onnx`` package is not
a dependency, so this module parses the subset of the protobuf wire format
that a ModelProto needs: initializers (external data included), nodes with
their attributes, ``If`` subgraphs, graph inputs and outputs.

Conversion to a native tower tree (``extract_tower_params``), in order:
1. **Name-based**: torch.onnx exports of open_clip models keep torch
   state-dict names for most initializers; ``weights.map_state_dict`` maps
   them.
2. **Structural**: constant-folded exporters emit anonymous names
   (``onnx::MatMul_123``) for transposed Linear weights; those are recovered
   by shape + graph-order matching against the architecture the config
   promises (``_structural_extract``).

Either way the tree is checked against the family's layout
(``weights.validate_tower_pytree``) and its tower's output against the graph
executor's (``probe_verify``) before it is accepted. (The JAX package
returns a name-mapped tree unchecked.) The ``derive_*_cfg`` functions read a
family's architecture from the graph itself.
"""

from __future__ import annotations

import re
import struct
from pathlib import Path
from typing import Iterator

import numpy as np

from .errors import WeightError

# --------------------------------------------------------------------------
# protobuf wire format
# --------------------------------------------------------------------------


def _read_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise WeightError("Malformed varint in ONNX file")


def _iter_fields(buf: memoryview) -> Iterator[tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over one message's bytes.

    wire types: 0 varint → int, 1 fixed64 → bytes, 2 length-delimited →
    memoryview, 5 fixed32 → bytes.
    """
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field = tag >> 3
        wtype = tag & 7
        if wtype == 0:
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:
            val = bytes(buf[pos : pos + 8])
            pos += 8
        elif wtype == 2:
            length, pos = _read_varint(buf, pos)
            if pos + length > n:
                # memoryview slicing would silently truncate — a corrupt
                # or cut-off download must fail loudly, not parse as an
                # empty graph
                raise WeightError(
                    "Truncated ONNX file: length-delimited field of "
                    f"{length} bytes at offset {pos} exceeds the buffer")
            val = buf[pos : pos + length]
            pos += length
        elif wtype == 5:
            val = bytes(buf[pos : pos + 4])
            pos += 4
        else:
            raise WeightError(f"Unsupported protobuf wire type {wtype}")
        yield field, wtype, val


# ONNX TensorProto.DataType → numpy
_DTYPES = {
    1: np.float32,
    2: np.uint8,
    3: np.int8,
    4: np.uint16,
    5: np.int16,
    6: np.int32,
    7: np.int64,
    9: np.bool_,
    10: np.float16,
    11: np.float64,
    12: np.uint32,
    13: np.uint64,
}
_BFLOAT16 = 16


class TensorInfo:
    __slots__ = ("name", "dims", "data_type", "raw", "float_data",
                 "int_data", "external", "data_location")

    def __init__(self):
        self.name = ""
        self.dims: list[int] = []
        self.data_type = 1
        self.raw: bytes | None = None
        self.float_data: list[float] = []
        self.int_data: list[int] = []
        self.external: dict[str, str] = {}
        self.data_location = 0


def _parse_tensor(buf: memoryview) -> TensorInfo:
    t = TensorInfo()
    for field, wtype, val in _iter_fields(buf):
        if field == 1:  # dims
            if wtype == 0:
                t.dims.append(val)
            else:  # packed
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    t.dims.append(v)
        elif field == 2 and wtype == 0:
            t.data_type = val
        elif field == 4:  # float_data (packed)
            t.float_data.extend(struct.unpack(f"<{len(val)//4}f", bytes(val)))
        elif field == 7:  # int64_data (packed or unpacked varints)
            # zigzag not used: plain varint two's complement (64-bit)
            if wtype == 0:
                t.int_data.append(_signed(val))
            else:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    t.int_data.append(_signed(v))
        elif field == 5:  # int32_data (packed or unpacked varints)
            # negative int32 is encoded as a 64-bit sign-extended varint
            # (NOT 32-bit two's complement); also carries fp16/bf16/u8/u16
            # payloads per the ONNX spec (one element per entry)
            if wtype == 0:
                t.int_data.append(_signed(val))
            else:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    t.int_data.append(_signed(v))
        elif field == 8 and wtype == 2:
            t.name = bytes(val).decode("utf-8")
        elif field == 9 and wtype == 2:
            t.raw = bytes(val)
        elif field == 13 and wtype == 2:  # external_data StringStringEntry
            key = value = ""
            for f2, _, v2 in _iter_fields(val):
                if f2 == 1:
                    key = bytes(v2).decode("utf-8")
                elif f2 == 2:
                    value = bytes(v2).decode("utf-8")
            t.external[key] = value
        elif field == 14 and wtype == 0:
            t.data_location = val
    return t


def _tensor_to_array(t: TensorInfo, base_dir: Path) -> np.ndarray:
    shape = tuple(t.dims)
    if t.data_location == 1:  # EXTERNAL
        location = t.external.get("location")
        if not location:
            raise WeightError(f"External tensor '{t.name}' missing location")
        offset = int(t.external.get("offset", "0"))
        count = int(np.prod(shape)) if shape else 1
        if t.data_type == _BFLOAT16:
            nbytes = count * 2
        elif t.data_type in _DTYPES:
            nbytes = count * np.dtype(_DTYPES[t.data_type]).itemsize
        else:
            raise WeightError(f"Unsupported external dtype {t.data_type}")
        length = int(t.external.get("length", str(nbytes)))
        with open(base_dir / location, "rb") as f:
            f.seek(offset)
            raw = f.read(length)
    else:
        raw = t.raw

    if raw is not None:
        if t.data_type == _BFLOAT16:
            u16 = np.frombuffer(raw, dtype=np.uint16)
            u32 = u16.astype(np.uint32) << 16
            return u32.view(np.float32).reshape(shape)
        if t.data_type not in _DTYPES:
            raise WeightError(
                f"Unsupported ONNX dtype {t.data_type} for '{t.name}'"
            )
        return np.frombuffer(raw, dtype=_DTYPES[t.data_type]).reshape(shape)

    if t.data_type == 1 and t.float_data:
        return np.asarray(t.float_data, dtype=np.float32).reshape(shape)
    if t.int_data:
        # ONNX stores many narrow dtypes element-wise in int32_data:
        # u8/i8/u16/i16/i32/bool plus fp16/bf16 bit patterns (one varint
        # per element); int64 uses int64_data — both land in t.int_data.
        if t.data_type == 10:  # float16 bit patterns
            u16 = np.asarray(t.int_data, dtype=np.int64).astype(np.uint16)
            return u16.view(np.float16).reshape(shape)
        if t.data_type == _BFLOAT16:
            u16 = np.asarray(t.int_data, dtype=np.int64).astype(np.uint16)
            return (u16.astype(np.uint32) << 16).view(np.float32).reshape(shape)
        if t.data_type in _DTYPES:
            return np.asarray(
                t.int_data, dtype=_DTYPES[t.data_type]
            ).reshape(shape)
    if t.data_type in (6, 7) and int(np.prod(shape)) == 0:
        return np.asarray(
            t.int_data, dtype=_DTYPES[t.data_type]
        ).reshape(shape)
    if int(np.prod(shape)) == 0:
        return np.zeros(shape, dtype=_DTYPES.get(t.data_type, np.float32))
    raise WeightError(f"Initializer '{t.name}' carries no data")


class OnnxGraph:
    """Parsed graph: initializers plus node skeleton (op_type, inputs,
    outputs) in file order — enough for structural weight recovery."""

    def __init__(self):
        self.initializers: dict[str, np.ndarray] = {}
        # (op_type, inputs, outputs, int_attrs) per node in file order
        self.nodes: list[tuple[str, list[str], list[str], dict[str, int]]] = []
        self.inputs: list[str] = []
        self.outputs: list[str] = []


def _signed(v: int) -> int:
    """Protobuf int64 varints are two's-complement; recover the sign."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _parse_attr(buf: memoryview):
    """Full AttributeProto: name + whichever payload is present.

    Returns (name, value) where value is int, float, bytes, np.ndarray
    (tensor, inline data only), or a list of ints/floats/bytes.
    """
    name = ""
    value = None
    ints: list[int] = []
    floats: list[float] = []
    strings: list[bytes] = []
    for field, wtype, val in _iter_fields(buf):
        if field == 1 and wtype == 2:
            name = bytes(val).decode("utf-8")
        elif field == 2 and wtype == 5:  # f
            value = struct.unpack("<f", val)[0]
        elif field == 3 and wtype == 0:  # i
            value = _signed(val)
        elif field == 4 and wtype == 2:  # s
            value = bytes(val)
        elif field == 5 and wtype == 2:  # t (TensorProto)
            t = _parse_tensor(val)
            try:
                # attribute tensors are inline in every torch export; an
                # external-data attr can't resolve from here (no base dir
                # plumbed) — treat unresolvable the same as absent rather
                # than crash (OSError) or read a same-named CWD file
                if t.data_location == 1:
                    raise WeightError(
                        f"external attribute tensor '{t.name}'")
                value = _tensor_to_array(t, Path("."))
            except (WeightError, OSError):
                value = None
        elif field == 6 and wtype == 2:  # g (GraphProto) — If branches
            try:
                value = _parse_graph_body(val, Path("."))
            except (WeightError, OSError):
                value = None
        elif field == 7:  # floats: packed (wtype 2) or repeated fixed32
            if wtype == 2:
                floats.extend(
                    struct.unpack(f"<{len(val) // 4}f", bytes(val)))
            elif wtype == 5:
                floats.append(struct.unpack("<f", val)[0])
        elif field == 8:  # ints: packed (wtype 2) or repeated varint
            if wtype == 2:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    ints.append(_signed(v))
            elif wtype == 0:
                ints.append(_signed(val))
        elif field == 9 and wtype == 2:  # strings
            strings.append(bytes(val))
    if ints:
        value = ints
    elif floats:
        value = floats
    elif strings:
        value = strings
    return name, value


def _parse_node(
    buf: memoryview,
) -> tuple[str, list[str], list[str], dict]:
    op_type = ""
    inputs: list[str] = []
    outputs: list[str] = []
    attrs: dict = {}
    for field, wtype, val in _iter_fields(buf):
        if field == 1 and wtype == 2:
            inputs.append(bytes(val).decode("utf-8"))
        elif field == 2 and wtype == 2:
            outputs.append(bytes(val).decode("utf-8"))
        elif field == 4 and wtype == 2:
            op_type = bytes(val).decode("utf-8")
        elif field == 5 and wtype == 2:  # attribute
            name, avalue = _parse_attr(val)
            if name and avalue is not None:
                attrs[name] = avalue
    return op_type, inputs, outputs, attrs


def _value_info_name(buf: memoryview) -> str:
    for field, wtype, val in _iter_fields(buf):
        if field == 1 and wtype == 2:
            return bytes(val).decode("utf-8")
    return ""


def _parse_graph_body(graph_buf: memoryview, base_dir: Path) -> OnnxGraph:
    """GraphProto → OnnxGraph (shared by the top-level graph and attribute
    subgraphs such as ``If`` branches)."""
    g = OnnxGraph()
    for field, wtype, val in _iter_fields(graph_buf):
        if field == 1 and wtype == 2:  # node
            g.nodes.append(_parse_node(val))
        elif field == 5 and wtype == 2:  # initializer
            t = _parse_tensor(val)
            g.initializers[t.name] = _tensor_to_array(t, base_dir)
        elif field == 11 and wtype == 2:
            g.inputs.append(_value_info_name(val))
        elif field == 12 and wtype == 2:
            g.outputs.append(_value_info_name(val))
    return g


def read_onnx(path: Path | str) -> OnnxGraph:
    """Parse a .onnx file (ModelProto) into an OnnxGraph, resolving external
    data relative to the file's directory."""
    path = Path(path)
    data = memoryview(path.read_bytes())
    graph_buf = None
    for field, wtype, val in _iter_fields(data):
        if field == 7 and wtype == 2:  # ModelProto.graph
            graph_buf = val
            break
    if graph_buf is None:
        raise WeightError(f"No graph found in ONNX file {path}")
    return _parse_graph_body(graph_buf, path.parent)


# --------------------------------------------------------------------------
# weight extraction
# --------------------------------------------------------------------------

_NAMED_MARKERS = (
    "transformer.resblocks.",  # open_clip towers
    "trunk.blocks.",           # timm towers
    "token_embedding",
    "conv1.weight",
    "patch_embed.proj",
    "stages.",                 # FastViT
    "encoder.layer.",          # HF BERT/RoBERTa text towers
)


def has_named_weights(g: OnnxGraph) -> bool:
    return any(
        any(marker in name for marker in _NAMED_MARKERS)
        for name in g.initializers
    )


def extract_tower_params(onnx_path: Path | str, spec, *, tower: str,
                         device="cpu") -> dict:
    """ONNX graph → tower tree (numpy arrays) for the given TowerSpec.

    Prefers name-based mapping; falls back to structural recovery for
    constant-folded exports. The tree from either route must match the
    family's layout (``weights.validate_tower_pytree``) and pass
    ``probe_verify`` (run on ``device``), else ``WeightError``.
    """
    from .weights import map_state_dict, validate_tower_pytree

    g = read_onnx(onnx_path)
    if has_named_weights(g):
        try:
            params = map_state_dict(g.initializers, tower=tower, family=spec.family)
            validate_tower_pytree(params, spec, source=onnx_path)
        except WeightError as name_err:
            # Mixed-name graphs are the common constant-folded case: LN and
            # conv initializers keep torch names while Linear/attention
            # weights fold to anonymous onnx::MatMul_* constants. When the
            # family has no structural path either, the name-based
            # diagnostic (which key was missing) is the real error: chain it.
            try:
                params = _structural_extract(g, spec, tower=tower)
            except WeightError as e:
                raise e from name_err
    else:
        params = _structural_extract(g, spec, tower=tower)
    validate_tower_pytree(params, spec, source=onnx_path)
    probe_verify(onnx_path, spec, tower=tower, params=params, device=device, graph=g)
    return params


# Conversion acceptance gate: a correct conversion matches the executor at
# ~1e-6 cosine distance (f32 both sides), so 1e-4 rejects even
# near-threshold misreads (wrong ln_eps, gelu vs gelu_tanh, off-by-one
# block assembly) with enormous margin while never rejecting a correct one.
_PROBE_MIN_COS = 1.0 - 1e-4


def _probe_text_ids(cfg) -> np.ndarray:
    """Probe id batch stressing the patterns that discriminate structural
    misreads: random rows, a repeated-token row, and padded-tail rows (pad
    position handling, causal masks, argmax/last pooling)."""
    rng = np.random.default_rng(0)
    ctx = int(cfg.context_length)
    vocab = int(cfg.vocab_size)
    ids = rng.integers(1, max(vocab, 3), (8, ctx))
    ids[6, :] = ids[6, 0]
    pad = int(getattr(cfg, "pad_id", 0))
    ids[4, ctx // 2:] = pad
    ids[5, max(1, ctx // 4):] = pad
    return ids.astype(np.int32)


def probe_verify(onnx_path: Path | str, spec, *, tower: str, params: dict,
                 device="cpu", graph: OnnxGraph | None = None) -> None:
    """Load-time self-verification of a conversion: run a probe batch
    through the converted native tower (its plain impl, f32) AND the graph
    executor (``onnx_exec``, f32) on the same graph, on ``device``, and
    raise :class:`WeightError` when they disagree — the load path then
    falls back to the executor, so a misread of a real-world export
    (another torch version, onnx-simplifier, a different opset) can never
    ship silently-wrong embeddings (reference: src/onnx.rs:13-29, where the
    graph IS the weights).

    When the executor itself cannot run the graph (an op outside its
    coverage) there is nothing to cross-check against — and nothing to
    fall back to — so the conversion is accepted with a loud warning.
    ``graph``: the already parsed ``onnx_path``, to skip a second parse.
    """
    import torch

    from .onnx_exec import OnnxTower
    from .ops.normalize import l2_normalize
    from .utils.logging import warn_once
    from .weights import params_from_numpy

    def unverified(reason: str) -> None:
        warn_once(
            f"probe_verify:{onnx_path}",
            "conversion of %s (family '%s') could not be cross-checked "
            "against the graph executor: %s — accepting unverified",
            str(onnx_path), spec.family, reason)

    dev = torch.device(device)
    try:
        etower = OnnxTower(onnx_path, device=dev, graph=graph)
    except Exception as e:  # noqa: BLE001 — any parse failure: can't verify
        unverified(f"executor cannot parse the graph ({e})")
        return

    cfg = spec.cfg
    nparams = params_from_numpy(params, device=dev, dtype=torch.float32)
    if tower == "text":
        from .text import text_tower

        ids = _probe_text_ids(cfg)
        ids_t = torch.from_numpy(ids).to(dev)
        mask_t = (ids_t != int(getattr(cfg, "pad_id", 0))).to(torch.int32)
        name = next((n for n in ("input_ids", "input")
                     if n in etower.input_names), etower.input_names[0])
        feeds = {name: ids_t}
        if "attention_mask" in etower.input_names:
            feeds["attention_mask"] = mask_t
        kw = {"attention_mask": mask_t} if spec.family == "hf_bert" else {}

        def native():
            return text_tower(spec, nparams)(ids_t, attn_impl="eager", **kw)
    else:
        from .vision import build_tower

        s = int(cfg.image_size)
        pix = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (2, 3, s, s)).astype(np.float32)).to(dev)
        name = next((n for n in ("pixel_values", "input")
                     if n in etower.input_names), etower.input_names[0])
        feeds = {name: pix}

        def native():
            return build_tower(spec, nparams)(pix, attn_impl="eager", channels_first=True)

    with torch.inference_mode():
        try:
            ref = l2_normalize(etower(feeds).float())
        except Exception as e:  # noqa: BLE001 — executor can't run this graph
            unverified(f"executor cannot execute the graph ({e})")
            return
        got = l2_normalize(native().float())
    ref, got = ref.cpu().numpy(), got.cpu().numpy()
    if got.shape != ref.shape:
        raise WeightError(
            f"{onnx_path}: conversion self-check failed — native "
            f"'{spec.family}' tower produced shape {got.shape}, the graph "
            f"executor {ref.shape}")
    cos = float(np.min(np.sum(ref * got, axis=-1)))
    if not (np.isfinite(cos) and cos > _PROBE_MIN_COS):
        raise WeightError(
            f"{onnx_path}: conversion self-check failed — probe "
            f"min-cosine {cos:.6f} vs the graph executor (required > "
            f"{_PROBE_MIN_COS}); the recovered '{spec.family}' weights do "
            "not reproduce the graph's own output")


def _consumption_order(g: OnnxGraph) -> list[str]:
    """Initializer names in first-consumption order over the node list.

    torch exports keep node order aligned with execution order, so this
    sequence visits parameters in the same order the model's forward
    consumes them — the key invariant structural recovery relies on.
    """
    seen: set[str] = set()
    order: list[str] = []
    for _, inputs, _, _ in g.nodes:
        for name in inputs:
            if name in g.initializers and name not in seen:
                seen.add(name)
                order.append(name)
    # initializers never referenced by nodes (rare) go last
    for name in g.initializers:
        if name not in seen:
            order.append(name)
    return order


class _Puller:
    """Sequential matcher: pull the next initializer whose shape is in the
    accepted set (searching a small lookahead window to skip constants like
    reshape shapes, masks, or scalar scales interleaved by the exporter)."""

    def __init__(self, g: OnnxGraph, *, lookahead: int = 24):
        order = _consumption_order(g)
        self.arrays = [g.initializers[n] for n in order]
        self.names = order
        self.pos = 0
        self.lookahead = lookahead
        # first consuming node per initializer: (op_type, int attrs)
        self.consumers: dict[str, tuple[str, dict[str, int]]] = {}
        for op_type, inputs, _, attrs in g.nodes:
            for name in inputs:
                if name in g.initializers and name not in self.consumers:
                    self.consumers[name] = (op_type, attrs)
        self.last_name: str | None = None

    def pull(self, *shapes: tuple, what: str = "",
             consumer_ops: tuple[str, ...] | None = None,
             lookahead: int | None = None,
             rewind: bool = False) -> np.ndarray:
        """``lookahead`` overrides the window for this pull (short windows
        keep optional probes from matching a look-alike weight far
        downstream); ``rewind`` consumes the match but restores ``pos``, so
        a parameter the exporter happened to order later (e.g. a packed
        attention bias consumed after the projection weights) can be taken
        out of order without skipping the weights in between."""
        shape_set = {tuple(s) for s in shapes}
        window = self.lookahead if lookahead is None else lookahead
        end = min(len(self.arrays), self.pos + window)
        for i in range(self.pos, end):
            if tuple(self.arrays[i].shape) in shape_set:
                if consumer_ops is not None:
                    op = self.consumers.get(self.names[i], ("", {}))[0]
                    if op not in consumer_ops:
                        continue
                arr = self.arrays[i]
                self.last_name = self.names[i]
                # consume: drop it so it can't match twice
                del self.arrays[i]
                del self.names[i]
                if not rewind:
                    self.pos = i
                return arr
        raise WeightError(
            f"Structural ONNX extraction: no initializer of shape "
            f"{sorted(shape_set)} near position {self.pos} (wanted {what})"
        )

    def maybe(self, *shapes: tuple,
              consumer_ops: tuple[str, ...] | None = None,
              lookahead: int | None = None,
              rewind: bool = False) -> np.ndarray | None:
        try:
            return self.pull(*shapes, what="optional",
                             consumer_ops=consumer_ops, lookahead=lookahead,
                             rewind=rewind)
        except WeightError:
            return None


# Ops that consume a PACKED projection weight whole (Split/Slice/chunk and
# layout shims). A MatMul/Gemm consumer means "this is itself a linear" —
# which is how a probe for a packed [3d, d] in_proj could otherwise steal
# the MLP fc weight of a ratio-3 tower sitting later in the window.
_PACKED_CONSUMERS = ("Split", "Slice", "Gather", "Transpose", "Reshape",
                     "Cast", "Identity")


def _maybe_packed(p: _Puller, *shapes: tuple) -> np.ndarray | None:
    """Probe for a packed projection weight without the steal hazards: a
    surviving packed weight is consumed right at the current position, so
    both branches use short windows — a ratio-3 MLP fc (MatMul-consumed,
    >=6 slots ahead behind out/LN/fc) and the next attention's packed
    in_proj (Split/Slice-consumed but >=10 slots ahead) stay out of reach.
    The consumer-evidence branch gets a slightly wider window since
    Split/Slice consumption can't be an MLP weight at all."""
    w = p.maybe(*shapes, consumer_ops=_PACKED_CONSUMERS, lookahead=6)
    if w is None:
        w = p.maybe(*shapes, lookahead=3)
    return w


def _pull_linear(p: _Puller, d_in: int, d_out: int, *, what: str,
                 bias: bool = True) -> dict:
    """Pull a Linear as either torch layout [out, in] (Gemm, transB) or
    folded layout [in, out] (MatMul constant). Rectangular weights orient by
    which shape matched; square weights are shape-ambiguous, so orient by
    the consuming node: Gemm with transB keeps torch [out, in] order (and
    transB=0 means the exporter already folded the transpose), while a
    MatMul constant is pre-transposed [in, out]."""
    w = p.pull((d_in, d_out), (d_out, d_in), what=what)
    if w.shape == (d_in, d_out) and d_in != d_out:
        mapped = np.ascontiguousarray(w)
    elif w.shape == (d_out, d_in) and d_in != d_out:
        mapped = np.ascontiguousarray(w.T)
    else:
        op, attrs = p.consumers.get(p.last_name or "", ("", {}))
        if op == "Gemm":
            transposed = bool(attrs.get("transB", 0))
            mapped = np.ascontiguousarray(w.T if transposed else w)
        elif op == "Transpose":
            # unfolded export: the Linear's [out, in] weight feeds an
            # explicit Transpose node before the MatMul
            mapped = np.ascontiguousarray(w.T)
        else:
            # MatMul (or unknown consumer, e.g. fused exports with no node
            # skeleton): folded constants are [in, out]; keep as-is.
            mapped = np.ascontiguousarray(w)
    out = {"w": mapped}
    if bias:
        b = p.maybe((d_out,))
        if b is not None:
            out["b"] = b
    return out


def _pull_ln(p: _Puller, d: int) -> dict:
    return {"scale": p.pull((d,), what="ln scale"),
            "bias": p.pull((d,), what="ln bias")}


def _structural_vit(g: OnnxGraph, cfg) -> dict:
    from .weights import _conv_to_patch, _stack_blocks

    p = _Puller(g)
    d = cfg.width
    params: dict = {}

    # Stem grammar: classic CLIP consumes conv (bias-free), then the class
    # token, then pos; timm ViTs consume conv + conv bias, then pos. A bare
    # maybe((d,)) after the conv is ambiguous between conv-bias and class
    # token, so branch on the family the config promises.
    conv = p.pull((d, 3, cfg.patch_size, cfg.patch_size), what="patch conv")
    params["patch_embed"] = {"w": _conv_to_patch(conv)}
    if cfg.use_class_token:
        cls = p.pull((d,), (1, 1, d), what="class token")
        params["cls_token"] = np.asarray(cls).reshape(1, 1, d)
    else:
        # guard against a bias-free conv: only an initializer actually
        # consumed by the Conv node may serve as its bias — otherwise a
        # greedy shape-only maybe((d,)) would steal the first LayerNorm
        # scale and shift every subsequent pull by one
        cb = p.maybe((d,), consumer_ops=("Conv",))
        if cb is not None:
            params["patch_embed"]["b"] = cb
    n_pos = cfg.num_patches + (1 if cfg.pos_embed_cls else 0)
    pos = p.pull((n_pos, d), (1, n_pos, d), what="pos embed")
    params["pos_embed"] = np.asarray(pos).reshape(1, n_pos, d)
    if cfg.use_ln_pre:
        params["ln_pre"] = _pull_ln(p, d)

    blocks = []
    for i in range(cfg.layers):
        block: dict = {"ln1": _pull_ln(p, d)}
        attn: dict = {}
        qkv = _maybe_packed(p, (3 * d, d), (d, 3 * d))
        if qkv is not None:
            w = qkv if qkv.shape == (3 * d, d) else qkv.T
            from .weights import _split_qkv

            attn = _split_qkv(np.ascontiguousarray(w),
                              p.maybe((3 * d,), lookahead=4))
        else:
            attn["q"] = _pull_linear(p, d, d, what=f"block{i} q")
            attn["k"] = _pull_linear(p, d, d, what=f"block{i} k")
            attn["v"] = _pull_linear(p, d, d, what=f"block{i} v")
        attn["out"] = _pull_linear(p, d, d, what=f"block{i} attn out")
        block["attn"] = attn
        block["ln2"] = _pull_ln(p, d)
        block["mlp"] = {
            "fc": _pull_linear(p, d, cfg.mlp_hidden, what=f"block{i} fc"),
            "proj": _pull_linear(p, cfg.mlp_hidden, d, what=f"block{i} proj"),
        }
        blocks.append(block)
    params["blocks"] = _stack_blocks(blocks)
    proj_in = d
    if cfg.pool == "attn":
        # CoCa legacy AttentionalPooler: consumption order in the exported
        # graph is ln_k → query → ln_q → q/k/v projections (separate when
        # dm != width; packed in_proj when equal; the single [3·dm]
        # in_proj_bias stays one Split-consumed initializer either way) →
        # out_proj → ln_post (over dm) → square projection.
        dm = cfg.attn_pool_dim or d
        nq = cfg.attn_pool_queries
        pool: dict = {"ln_k": _pull_ln(p, d)}
        pool["query"] = np.ascontiguousarray(
            p.pull((nq, dm), what="pool query"))
        pool["ln_q"] = _pull_ln(p, dm)
        # rewind: torch exports slice the packed bias before the projection
        # weights today, but nothing guarantees that order — take the bias
        # wherever it sits without advancing past unconsumed weights
        packed_b = p.maybe((3 * dm,), rewind=True)
        attn: dict = {}
        qkv = _maybe_packed(p, (3 * dm, dm), (dm, 3 * dm)) \
            if dm == d else None
        if qkv is not None:
            from .weights import _split_qkv

            w = qkv if qkv.shape == (3 * dm, dm) else qkv.T
            attn = _split_qkv(np.ascontiguousarray(w), packed_b)
        else:
            attn["q"] = _pull_linear(p, dm, dm, what="pool q",
                                     bias=packed_b is None)
            attn["k"] = _pull_linear(p, d, dm, what="pool k",
                                     bias=packed_b is None)
            attn["v"] = _pull_linear(p, d, dm, what="pool v",
                                     bias=packed_b is None)
            if packed_b is not None:
                for i, nm in enumerate(("q", "k", "v")):
                    attn[nm]["b"] = np.asarray(
                        packed_b[i * dm:(i + 1) * dm])
        attn["out"] = _pull_linear(p, dm, dm, what="pool out")
        pool["attn"] = attn
        params["attn_pool"] = pool
        params["ln_post"] = _pull_ln(p, dm)
        proj_in = dm
    else:
        params["ln_post"] = _pull_ln(p, d)

    if cfg.pool == "map":
        pool_hidden = cfg.pool_mlp_hidden or cfg.mlp_hidden
        probe = p.pull((1, 1, d), (d,), what="attn_pool probe")
        # Pool qkv packing varies by source module: PE's nn.MultiheadAttention
        # keeps one named [3d, d] in_proj_weight (Split node consumes it),
        # timm's AttentionPoolLatent exports a separate q plus packed kv.
        qkv = _maybe_packed(p, (3 * d, d), (d, 3 * d))
        if qkv is not None:
            from .weights import _split_qkv

            w = qkv if qkv.shape == (3 * d, d) else qkv.T
            pool_attn = _split_qkv(np.ascontiguousarray(w),
                                   p.maybe((3 * d,), lookahead=4))
        else:
            pool_attn = {
                "q": _pull_linear(p, d, d, what="pool q"),
            }
            kv = _maybe_packed(p, (2 * d, d), (d, 2 * d))
            if kv is not None:
                w = kv if kv.shape == (2 * d, d) else kv.T
                kvb = p.maybe((2 * d,), lookahead=4)
                pool_attn["k"] = {"w": np.ascontiguousarray(w[:d].T)}
                pool_attn["v"] = {"w": np.ascontiguousarray(w[d:].T)}
                if kvb is not None:
                    pool_attn["k"]["b"] = kvb[:d]
                    pool_attn["v"]["b"] = kvb[d:]
            else:
                pool_attn["k"] = _pull_linear(p, d, d, what="pool k")
                pool_attn["v"] = _pull_linear(p, d, d, what="pool v")
        pool_attn["out"] = _pull_linear(p, d, d, what="pool out")
        params["attn_pool"] = {
            "probe": np.asarray(probe).reshape(1, 1, d),
            "attn": pool_attn,
            "ln": _pull_ln(p, d),
            "mlp": {
                "fc": _pull_linear(p, d, pool_hidden, what="pool fc"),
                "proj": _pull_linear(p, pool_hidden, d, what="pool proj"),
            },
        }
    if cfg.use_proj:
        params["proj"] = _pull_linear(p, proj_in, cfg.embed_dim,
                                      what="projection", bias=cfg.proj_bias)
    return params


def _structural_text(g: OnnxGraph, cfg) -> dict:
    from .weights import _split_qkv, _stack_blocks

    if any(op_type == "Conv" for op_type, _, _, _ in g.nodes):
        # a plain text transformer has no convs; without this guard the
        # shape-matching puller could mis-assemble a conv-hybrid (MCT-class)
        # graph into plausible-looking transformer weights instead of
        # failing over to the hybrid lift / executor
        raise WeightError(
            "text graph contains Conv nodes — not a plain text transformer "
            "(MCT-class hybrids route via derive_mct_cfg)")
    p = _Puller(g)
    d = cfg.width
    params: dict = {
        "token_embed": p.pull((cfg.vocab_size, d), what="token embedding"),
    }
    n_pos = cfg.context_length + (1 if getattr(cfg, "embed_cls", False)
                                  else 0)
    if getattr(cfg, "embed_cls", False):
        # CoCa: the cls parameter is consumed (Expand/Concat) before the
        # positional add
        params["cls_emb"] = np.asarray(
            p.pull((d,), (1, 1, d), what="cls_emb")).reshape(1, 1, d)
    params["pos_embed"] = np.asarray(
        p.pull((n_pos, d), (1, n_pos, d), what="pos embed")
    ).reshape(n_pos, d)
    blocks = []
    for i in range(cfg.layers):
        block: dict = {"ln1": _pull_ln(p, d)}
        attn: dict = {}
        qkv = _maybe_packed(p, (3 * d, d), (d, 3 * d))
        if qkv is not None:
            w = qkv if qkv.shape == (3 * d, d) else qkv.T
            attn = _split_qkv(np.ascontiguousarray(w),
                              p.maybe((3 * d,), lookahead=4))
        else:
            attn["q"] = _pull_linear(p, d, d, what=f"block{i} q")
            attn["k"] = _pull_linear(p, d, d, what=f"block{i} k")
            attn["v"] = _pull_linear(p, d, d, what=f"block{i} v")
        attn["out"] = _pull_linear(p, d, d, what=f"block{i} attn out")
        block["attn"] = attn
        block["ln2"] = _pull_ln(p, d)
        block["mlp"] = {
            "fc": _pull_linear(p, d, cfg.mlp_hidden, what=f"block{i} fc"),
            "proj": _pull_linear(p, cfg.mlp_hidden, d, what=f"block{i} proj"),
        }
        blocks.append(block)
    params["blocks"] = _stack_blocks(blocks)
    params["ln_final"] = _pull_ln(p, d)
    if cfg.use_proj:
        # _pull_linear disambiguates the square embed_dim==width case via
        # the consuming node's Gemm/transB attrs (a hand-rolled keep-as-is
        # would silently transpose torch-layout square projections)
        params["proj"] = _pull_linear(p, d, cfg.embed_dim, what="text proj",
                                      bias=cfg.proj_bias)
    return params


def _structural_eva02(g: OnnxGraph, cfg) -> dict:
    """EVA02 (rope + SwiGLU + sub-LN) structural recovery. Per-block
    consumption order in a torch export: ln1 → q (bias) → k (NO bias) →
    v (bias) → [rope sin/cos constants — distinct shapes, skipped] →
    inner_ln → out → ln2 → w_gate → w_x → ffn_ln (hidden-dim) → w_out.
    The rope tables are runtime-computed here (models.eva02.rope_embed),
    so the graph's baked tables are ignored."""
    from .weights import _conv_to_patch, _stack_blocks

    p = _Puller(g)
    d, hidden = cfg.width, cfg.mlp_hidden
    conv = p.pull((d, 3, cfg.patch_size, cfg.patch_size), what="patch conv")
    params: dict = {"patch_embed": {"w": _conv_to_patch(conv)}}
    cb = p.maybe((d,), consumer_ops=("Conv",))
    if cb is not None:
        params["patch_embed"]["b"] = cb
    cls = p.pull((d,), (1, 1, d), what="cls token")
    params["cls_token"] = np.asarray(cls).reshape(1, 1, d)
    n = cfg.grid ** 2 + 1
    pos = p.pull((n, d), (1, n, d), what="pos embed")
    params["pos_embed"] = np.asarray(pos).reshape(1, n, d)
    blocks = []
    for i in range(cfg.layers):
        block: dict = {"ln1": _pull_ln(p, d)}
        block["attn"] = {
            "q": _pull_linear(p, d, d, what=f"block{i} q"),
            "k": _pull_linear(p, d, d, what=f"block{i} k", bias=False),
            "v": _pull_linear(p, d, d, what=f"block{i} v"),
            "inner_ln": _pull_ln(p, d),
            "out": _pull_linear(p, d, d, what=f"block{i} attn out"),
        }
        block["ln2"] = _pull_ln(p, d)
        block["mlp"] = {
            "w_gate": _pull_linear(p, d, hidden, what=f"block{i} w_gate"),
            "w_x": _pull_linear(p, d, hidden, what=f"block{i} w_x"),
            "ffn_ln": _pull_ln(p, hidden),
            "w_out": _pull_linear(p, hidden, d, what=f"block{i} w_out"),
        }
        blocks.append(block)
    params["blocks"] = _stack_blocks(blocks)
    params["ln_post"] = _pull_ln(p, d)
    if cfg.use_proj:
        params["proj"] = _pull_linear(p, d, cfg.embed_dim, what="projection")
    return params


def _pull_conv(p: _Puller, cout: int, cin: int, k: int, *,
               groups: int = 1, what: str = "") -> dict:
    """Pull a Conv2d (ONNX OIHW [cout, cin/g, k, k]) → HWIO pytree, with its
    bias when the Conv node consumes one. When the conv is immediately
    followed by a BatchNormalization over the same channel count (the
    unfolded-export form of timm's ConvNormAct — torch.onnx with
    do_constant_folding=True fuses the pair into one Conv, without folding
    it stays split), fold the BN into the conv weights here, matching
    models.fastvit.map_fastvit_visual's checkpoint-side fold."""
    w = p.pull((cout, cin // groups, k, k), what=what or "conv")
    out = {"w": np.ascontiguousarray(np.asarray(w).transpose(2, 3, 1, 0))}
    b = p.maybe((cout,), consumer_ops=("Conv",), lookahead=1)
    out["b"] = b if b is not None else np.zeros(cout, np.float32)
    # Only a BIAS-FREE conv may own a trailing BN (ConvNormAct's conv has
    # bias=False; every reparameterized conv carries a bias) — without the
    # gate, a biased conv sitting right before a standalone BN (FastViT's
    # RepCPE before an attention block's norm) would absorb that BN.
    # Strictly-next probe: the owned BN's scale is the immediately
    # following initializer.
    bn_scale = None if b is not None else p.maybe(
        (cout,), consumer_ops=("BatchNormalization",), lookahead=1)
    if bn_scale is not None:
        from .weights import fold_bn_affine

        eps = float(p.consumers.get(p.last_name or "",
                                    ("", {}))[1].get("epsilon", 1e-5))
        bn_b = p.pull((cout,), what=f"{what} bn bias",
                      consumer_ops=("BatchNormalization",), lookahead=1)
        mean = p.pull((cout,), what=f"{what} bn mean",
                      consumer_ops=("BatchNormalization",), lookahead=1)
        var = p.pull((cout,), what=f"{what} bn var",
                     consumer_ops=("BatchNormalization",), lookahead=1)
        scale, bias = fold_bn_affine(bn_scale, bn_b, mean, var, eps=eps)
        out["w"] = (out["w"] * scale[None, None, None, :]).astype(np.float32)
        out["b"] = (np.asarray(out["b"], np.float64) * scale
                    + bias).astype(np.float32)
    return out


# layer-scale gammas arrive as [dim] (unfolded: consumed by the view's
# Reshape), or constant-folded to the broadcast shape the Mul consumes
def _pull_layer_scale(p: _Puller, dim: int, *, what: str) -> np.ndarray:
    ls = p.pull((dim,), (dim, 1, 1), (1, dim, 1, 1), what=what,
                consumer_ops=("Mul", "Reshape"))
    return np.asarray(ls).reshape(-1)


def _structural_fastvit(g: OnnxGraph, cfg) -> dict:
    """FastViT / MobileCLIP MCi structural recovery (reference's published
    MobileCLIP2 dirs — README.md:106-113 — ship this family as ONNX).

    torch.onnx exports of the reparameterized tower are the canonical
    partially-folded case: plain convs keep their state-dict names, but
    (a) ConvFFN's bias-free dw conv + BatchNorm folds into ONE anonymous
    ``onnx::Conv_*`` pair, (b) attention qkv/proj Linears fold to anonymous
    pre-transposed ``onnx::MatMul_*`` constants, and (c) layer-scale gammas
    fold to ``[1, dim, 1, 1]`` Mul constants. Consumption order against the
    config-promised architecture recovers all of them; the unfolded export
    (named weights, live BatchNormalization nodes, Transpose-consumed
    Linears) rides the same pulls.

    Per-stage consumption order (mirrors timm's reparameterized forward):
    stem conv ×3 → [downsample dw+pw] → [RepCPE conv] → blocks, where a
    RepMixer block consumes mixer-conv → ffn(dw[+bn] → fc1 → fc2) → ls and
    an attention block consumes norm-BN ×4 → qkv → proj → ls1 → ffn → ls2;
    then final_conv → head."""
    from .weights import _split_qkv, _stack_blocks, fold_bn_affine

    p = _Puller(g)
    c0 = cfg.dims[0]
    params: dict = {
        "stem": [
            _pull_conv(p, c0, 3, 3, what="stem conv"),
            _pull_conv(p, c0, c0, 3, groups=c0, what="stem dw"),
            _pull_conv(p, c0, c0, 1, what="stem pw"),
        ],
        "stages": [],
    }

    for i, (depth, dim) in enumerate(zip(cfg.depths, cfg.dims)):
        stage: dict = {}
        if i > 0:
            prev = cfg.dims[i - 1]
            stage["downsample"] = {
                "dw": _pull_conv(p, prev, prev, 7, groups=prev,
                                 what=f"stage{i} downsample dw"),
                "pw": _pull_conv(p, dim, prev, 1,
                                 what=f"stage{i} downsample pw"),
            }
        if cfg.pos_embs[i]:
            stage["cpe"] = _pull_conv(p, dim, dim, 7, groups=dim,
                                      what=f"stage{i} cpe")
        hidden = int(dim * cfg.mlp_ratios[i])
        blocks = []
        for j in range(depth):
            block: dict = {}
            if cfg.mixers[i] == "repmixer":
                block["mixer"] = _pull_conv(p, dim, dim, 3, groups=dim,
                                            what=f"s{i}b{j} mixer")
            else:
                # standalone pre-attention BatchNorm → per-channel affine
                bn = [p.pull((dim,), what=f"s{i}b{j} norm",
                             consumer_ops=("BatchNormalization",))
                      for _ in range(4)]
                eps = float(p.consumers.get(
                    p.last_name or "", ("", {}))[1].get("epsilon", 1e-5))
                scale, bias = fold_bn_affine(bn[0], bn[1], bn[2], bn[3],
                                             eps=eps)
                qkv = p.pull((3 * dim, dim), (dim, 3 * dim),
                             what=f"s{i}b{j} qkv")
                w = qkv if qkv.shape == (3 * dim, dim) else qkv.T
                attn = _split_qkv(np.ascontiguousarray(w),
                                  p.maybe((3 * dim,), lookahead=4))
                attn["out"] = _pull_linear(p, dim, dim, what=f"s{i}b{j} proj")
                block["mixer"] = {
                    "affine": {"scale": scale.astype(np.float32),
                               "bias": bias.astype(np.float32)},
                    "attn": attn,
                    "ls": _pull_layer_scale(p, dim, what=f"s{i}b{j} ls1"),
                }
            block["ffn"] = {
                "dw": _pull_conv(p, dim, dim, 7, groups=dim,
                                 what=f"s{i}b{j} ffn dw"),
                "fc1": _pull_conv(p, hidden, dim, 1, what=f"s{i}b{j} fc1"),
                "fc2": _pull_conv(p, dim, hidden, 1, what=f"s{i}b{j} fc2"),
                "ls": _pull_layer_scale(p, dim, what=f"s{i}b{j} ffn ls"),
            }
            blocks.append(block)
        stage["blocks"] = _stack_blocks(blocks)
        params["stages"].append(stage)

    c_last = cfg.dims[-1]
    c_final = int(c_last * cfg.final_conv_ratio)
    params["final_conv"] = _pull_conv(p, c_final, c_last, 3, groups=c_last,
                                      what="final conv")
    if cfg.use_head_proj:
        params["head"] = _pull_linear(p, c_final, cfg.embed_dim,
                                      what="head")
    return params


def _first_consumer_idx(g: OnnxGraph) -> dict[str, int]:
    """Node index of each initializer's first consumer (graph-position
    evidence for order-dependent decisions, e.g. LN-before-or-after-pool)."""
    out: dict[str, int] = {}
    for idx, (_, inputs, _, _) in enumerate(g.nodes):
        for name in inputs:
            if name in g.initializers and name not in out:
                out[name] = idx
    return out


def _structural_convnext(g: OnnxGraph, cfg) -> dict:
    """ConvNeXt structural recovery (laion CLIP-convnext family,
    "any open_clip model" — reference: src/onnx.rs:13-29, README.md:130).

    Consumption order mirrors timm's forward: stem conv4/s4 → stem LN →
    per stage ([downsample LN → conv2/s2] → blocks of dw7 → LN → fc1 →
    fc2 → layer-scale gamma) → head LN (before the global pool for
    head_norm_first checkpoints, after it otherwise — disambiguated by
    node position vs the spatial ReduceMean) → open_clip projection.
    All ConvNeXt MLPs use the fixed ratio-4 hidden dim."""
    from .weights import _stack_blocks

    p = _Puller(g)
    c0 = cfg.dims[0]
    params: dict = {
        "stem_conv": _pull_conv(p, c0, 3, 4, what="stem conv"),
        "stem_norm": _pull_ln(p, c0),
        "stages": [],
    }
    for i, (depth, dim) in enumerate(zip(cfg.depths, cfg.dims)):
        stage: dict = {}
        if i > 0:
            prev = cfg.dims[i - 1]
            stage["downsample_norm"] = _pull_ln(p, prev)
            stage["downsample_conv"] = _pull_conv(
                p, dim, prev, 2, what=f"stage{i} downsample")
        blocks = []
        for j in range(depth):
            block: dict = {
                "dw": _pull_conv(p, dim, dim, 7, groups=dim,
                                 what=f"s{i}b{j} dw"),
                "norm": _pull_ln(p, dim),
                "fc1": _pull_linear(p, dim, 4 * dim, what=f"s{i}b{j} fc1"),
                "fc2": _pull_linear(p, 4 * dim, dim, what=f"s{i}b{j} fc2"),
            }
            gamma = p.maybe((dim,), (dim, 1, 1), (1, dim, 1, 1),
                            consumer_ops=("Mul", "Reshape"), lookahead=2)
            if gamma is not None:
                block["gamma"] = np.asarray(gamma).reshape(-1)
            blocks.append(block)
        stage["blocks"] = _stack_blocks(blocks)
        params["stages"].append(stage)

    c_last = cfg.dims[-1]
    ln_scale = p.pull((c_last,), what="head ln scale")
    head_ln_name = p.last_name
    head_ln = {"scale": ln_scale, "bias": p.pull((c_last,),
                                                 what="head ln bias")}
    # pre-pool (norm_pre, head_norm_first checkpoints) vs post-pool
    # (head.norm): the spatial global-average ReduceMean's node position
    # tells them apart
    consumer_idx = _first_consumer_idx(g)
    pool_idx = [idx for idx, (op, _, _, attrs) in enumerate(g.nodes)
                if (op == "GlobalAveragePool")
                or (op == "ReduceMean"
                    and len(attrs.get("axes") or []) == 2)]
    ln_idx = consumer_idx.get(head_ln_name or "", -1)
    if pool_idx and ln_idx < pool_idx[-1]:
        params["pre_norm"] = head_ln
    else:
        params["head_norm"] = head_ln

    if cfg.proj == "linear":
        params["proj"] = _pull_linear(p, c_last, cfg.embed_dim, what="proj")
    elif cfg.proj == "mlp":
        params["proj"] = {
            "fc1": _pull_linear(p, c_last, c_last, what="proj fc1"),
            "fc2": _pull_linear(p, c_last, cfg.embed_dim, what="proj fc2"),
        }
    return params


def _resnet_conv_events(g: OnnxGraph) -> list[tuple]:
    """Ordered (w_hwio, affine{scale,bias}) pairs for every Conv node, with
    any directly-following BatchNormalization folded into the affine.

    Unlike the transformer families, the folded torch export of a
    ModifiedResNet fuses each BatchNorm into its conv's weights + a bias
    constant whose *consumption order* is scrambled (torch hoists the bias
    Unsqueeze constants to the graph head), so recovery walks the Conv
    nodes directly — each node names its own weight and bias inputs."""
    const_w: dict[str, np.ndarray] = {}
    for op_type, _, outputs, attrs in g.nodes:
        if op_type == "Constant" and outputs \
                and isinstance(attrs.get("value"), np.ndarray):
            const_w[outputs[0]] = attrs["value"]

    def resolve(name: str) -> np.ndarray | None:
        arr = g.initializers.get(name)
        return arr if arr is not None else const_w.get(name)

    # tensor name -> consuming nodes (to find a conv's trailing BN)
    consumers: dict[str, list[tuple]] = {}
    for node in g.nodes:
        for inp in node[1]:
            consumers.setdefault(inp, []).append(node)

    events = []
    for op_type, inputs, outputs, attrs in g.nodes:
        if op_type != "Conv" or len(inputs) < 2:
            continue
        w = resolve(inputs[1])
        if w is None or w.ndim != 4:
            continue
        cout = int(w.shape[0])
        b = resolve(inputs[2]) if len(inputs) > 2 else None
        b = np.asarray(b, np.float64) if b is not None \
            else np.zeros(cout, np.float64)
        scale = np.ones(cout, np.float64)
        bias = b
        cons = consumers.get(outputs[0], []) if outputs else []
        if len(cons) == 1 and cons[0][0] == "BatchNormalization":
            from .weights import fold_bn_affine

            _, bn_in, _, bn_attrs = cons[0]
            gamma, beta, mean, var = (resolve(n) for n in bn_in[1:5])
            if any(v is None for v in (gamma, beta, mean, var)):
                raise WeightError(
                    "BatchNormalization with non-constant parameters")
            s, off = fold_bn_affine(gamma, beta, mean, var,
                                    eps=float(bn_attrs.get("epsilon", 1e-5)))
            # BN(conv(x) + b) = conv(x)·s + (b·s + off)
            scale, bias = s, b * s + off
        events.append((
            np.ascontiguousarray(np.asarray(w).transpose(2, 3, 1, 0)),
            {"scale": scale.astype(np.float32),
             "bias": bias.astype(np.float32)},
        ))
    return events


def _structural_resnet(g: OnnxGraph, cfg) -> dict:
    """ModifiedResNet structural recovery (RN50/RN101 class,
    "any open_clip model" — reference: src/onnx.rs:13-29, README.md:130).

    Conv+BN pairs come from the node-ordered graph walk
    (:func:`_resnet_conv_events` — handles both the folded form, BN fused
    into conv bias constants, and the unfolded form, live
    BatchNormalization nodes). Node order mirrors the forward: 3-conv stem
    → stages of bottlenecks (conv1 → conv2 → [avgpool] → conv3 →
    [downsample]) → AttentionPool2d (pos-embed add → q/k/v → c_proj),
    the pool recovered by consumption order."""
    events = _resnet_conv_events(g)

    def take(cout, cin, k, what):
        if not events:
            raise WeightError(f"ModifiedResNet recovery: ran out of convs "
                              f"(wanted {what})")
        w, affine = events.pop(0)
        if w.shape != (k, k, cin, cout):
            raise WeightError(
                f"ModifiedResNet recovery: conv shape {w.shape} != expected "
                f"{(k, k, cin, cout)} (wanted {what})")
        return w, affine

    w = cfg.width
    params: dict = {"stages": []}
    params["conv1"], params["bn1"] = take(w // 2, 3, 3, "stem conv1")
    params["conv2"], params["bn2"] = take(w // 2, w // 2, 3, "stem conv2")
    params["conv3"], params["bn3"] = take(w, w // 2, 3, "stem conv3")

    cin = w
    for stage_idx, depth in enumerate(cfg.layers):
        planes = w * (2 ** stage_idx)
        cout = planes * EXPANSION_RESNET
        stage = []
        for bi in range(depth):
            block: dict = {}
            block["conv1"], block["bn1"] = take(
                planes, cin, 1, f"l{stage_idx}b{bi} conv1")
            block["conv2"], block["bn2"] = take(
                planes, planes, 3, f"l{stage_idx}b{bi} conv2")
            block["conv3"], block["bn3"] = take(
                cout, planes, 1, f"l{stage_idx}b{bi} conv3")
            if bi == 0 and cin != cout:
                dw, dbn = take(cout, cin, 1,
                               f"l{stage_idx}b{bi} downsample")
                block["downsample"] = {"conv": dw, "bn": dbn}
            stage.append(block)
            cin = cout
        params["stages"].append(stage)
    if events:
        raise WeightError(
            f"ModifiedResNet recovery: {len(events)} unconsumed conv(s) — "
            "the config's layers/width do not match this graph")

    tokens = cfg.pool_tokens
    p = _Puller(g, lookahead=len(g.initializers) + 1)
    pool: dict = {
        "pos_embed": np.asarray(
            p.pull((tokens, cin), (1, tokens, cin), (tokens, 1, cin),
                   what="attnpool pos embed")).reshape(tokens, cin),
    }
    for name in ("q", "k", "v"):
        pool[name] = _pull_linear(p, cin, cin, what=f"attnpool {name}")
    if all("b" not in pool[n] for n in "qkv"):
        # unfolded multi_head_attention_forward export: the three biases
        # ride as one packed in_proj_bias [3C] (folding splits it)
        packed = p.maybe((3 * cin,), lookahead=6)
        if packed is not None:
            for n, seg in zip("qkv", np.split(np.asarray(packed), 3)):
                pool[n]["b"] = seg
    pool["out"] = _pull_linear(p, cin, cfg.embed_dim, what="attnpool c_proj")
    params["attnpool"] = pool
    return params


EXPANSION_RESNET = 4


def derive_convnext_cfg(onnx_path: Path | str) -> dict:
    """Recover the ConvNeXt stage architecture (depths/dims) from the
    exported visual graph — the derive_fastvit_cfg pattern. Stage
    boundaries are the 2×2/s2 downsample convs; block count per stage is
    the number of dw7 group-convs at that width.

    Raises WeightError when the graph is not ConvNeXt-shaped."""
    g = read_onnx(onnx_path)
    const_w: dict[str, np.ndarray] = {}
    for op_type, _, outputs, attrs in g.nodes:
        if op_type == "Constant" and outputs \
                and isinstance(attrs.get("value"), np.ndarray):
            const_w[outputs[0]] = attrs["value"]

    convs: list[tuple[int, int, int, int, int]] = []  # o, in, k, grp, stride
    for op_type, inputs, _, attrs in g.nodes:
        if op_type != "Conv" or len(inputs) < 2:
            continue
        arr = g.initializers.get(inputs[1])
        if arr is None:
            arr = const_w.get(inputs[1])
        if arr is None or arr.ndim != 4:
            continue
        o, ipg, kh, kw = (int(s) for s in arr.shape)
        grp = int(attrs.get("group", 1))
        st = int((attrs.get("strides") or [1, 1])[0])
        if kh == kw:
            convs.append((o, ipg * grp, kh, grp, st))
    if not convs or convs[0][1] != 3 or convs[0][2] != 4 or convs[0][4] != 4:
        raise WeightError(
            f"{onnx_path}: no 4x4/s4 RGB patchify stem — not a ConvNeXt "
            "graph")
    dims = [convs[0][0]]
    depths = [0]
    for o, cin, k, grp, st in convs[1:]:
        if k == 7 and grp == dims[-1] and o == dims[-1]:
            depths[-1] += 1
        elif k == 2 and st == 2 and cin == dims[-1]:
            dims.append(o)
            depths.append(0)
        else:
            raise WeightError(
                f"{onnx_path}: unexpected conv (out={o}, in={cin}, k={k}, "
                f"groups={grp}, stride={st}) at width {dims[-1]} — not a "
                "ConvNeXt-shaped graph")
    if any(d == 0 for d in depths):
        raise WeightError(f"{onnx_path}: empty ConvNeXt stage")
    return {"depths": tuple(depths), "dims": tuple(dims)}


def derive_resnet_cfg(onnx_path: Path | str) -> dict:
    """Recover the ModifiedResNet architecture from the exported visual
    graph: per-stage bottleneck counts from the 1×1/3×3/1×1 conv events
    (stage boundary = planes doubling), width from the stem, heads from
    the attention reshape constants, embed dim from the trailing c_proj.

    Raises WeightError when the graph is not ModifiedResNet-shaped."""
    g = read_onnx(onnx_path)
    convs: list[tuple[int, int, int]] = []  # o, in, k
    for op_type, inputs, _, attrs in g.nodes:
        if op_type != "Conv" or len(inputs) < 2:
            continue
        arr = g.initializers.get(inputs[1])
        if arr is None or arr.ndim != 4 or int(attrs.get("group", 1)) != 1:
            continue
        o, i, kh, kw = (int(s) for s in arr.shape)
        if kh == kw:
            convs.append((o, i, kh))
    if len(convs) < 12 or convs[0][1] != 3 or convs[0][2] != 3:
        raise WeightError(
            f"{onnx_path}: no 3-conv ResNet stem — not a ModifiedResNet "
            "graph")
    half = convs[0][0]
    if not (convs[1] == (half, half, 3) and convs[2][1] == half
            and convs[2][2] == 3):
        raise WeightError(f"{onnx_path}: stem is not conv3×3 at {half}")
    width = convs[2][0]

    # bottlenecks: conv1 1×1 [p, cin] → conv2 3×3 [p, p] → conv3 1×1 [4p, p]
    # (+ optional downsample 1×1). planes doubles at each stage boundary.
    layers: list[int] = []
    planes = None
    i = 3
    n = len(convs)
    while i + 2 < n:
        o1, c1, k1 = convs[i]
        o2, c2, k2 = convs[i + 1]
        o3, c3, k3 = convs[i + 2]
        if not (k1 == 1 and k2 == 3 and k3 == 1 and o1 == o2 == c2 == c3
                and o3 == EXPANSION_RESNET * o1):
            break
        if planes is None or o1 == 2 * planes:
            layers.append(0)
            planes = o1
        elif o1 != planes:
            raise WeightError(
                f"{onnx_path}: bottleneck planes {o1} break the "
                f"stage-doubling pattern (was {planes})")
        layers[-1] += 1
        i += 3
        # optional downsample conv
        if i < n and convs[i][2] == 1 and convs[i][0] == o3 \
                and convs[i][1] != o3:
            i += 1
    if len(layers) != 4:
        raise WeightError(
            f"{onnx_path}: found {len(layers)} bottleneck stages, "
            "ModifiedResNet has 4")
    feat = width * 32
    votes = [h for h in _head_votes(g, feat) if h > 1]
    heads = max(set(votes), key=votes.count) if votes else width * 32 // 64
    # the c_proj: the only 2-D initializer pairing feat with a DIFFERENT
    # dim (q/k/v are square [feat, feat]; dict order is not node order)
    embeds = {int(a.shape[0]) if int(a.shape[1]) == feat else int(a.shape[1])
              for a in g.initializers.values()
              if a.ndim == 2 and feat in a.shape
              and int(a.shape[0]) != int(a.shape[1])}
    cfg = {"layers": tuple(layers), "width": width, "heads": heads}
    if len(embeds) == 1:
        cfg["embed_dim"] = embeds.pop()
    return cfg


def _structural_bert(g: OnnxGraph, cfg) -> dict:
    """HF BERT/RoBERTa text-tower structural recovery (BiomedCLIP class,
    reference README.md:143). torch exports of transformers towers are the
    canonical mixed-name case: embeddings / LayerNorms / biases keep their
    state-dict names while every Linear weight folds to an anonymous
    pre-transposed ``onnx::MatMul_*`` constant — consumption order against
    the BertModel forward recovers them all.

    Per-block order (transformers BertLayer): q → k → v → attention output
    dense → LN → intermediate dense → output dense → LN; embeddings consume
    word → token-type → position → LN ahead of the blocks; the optional
    tanh pooler and the open_clip projection trail the encoder.
    """
    from .weights import _stack_blocks

    p = _Puller(g)
    d, inter = cfg.width, cfg.mlp_hidden
    n_pos = cfg.max_pos or cfg.context_length

    params: dict = {
        "word_embed": p.pull((cfg.vocab_size, d), what="word embeddings"),
    }
    # token-type table: tiny row count (2 for BERT, 1 for XLM-R). When the
    # exporter constant-folds the all-zeros token_type_ids lookup, the add
    # arrives as a [ctx, d] (or [1, ctx, d]) row-constant instead — keep
    # its first row as a 1-row table (apply() reads type_embed[0]).
    type_tab = p.maybe((1, d), (2, d), (4, d), (8, d), (16, d))
    if type_tab is None:
        folded = p.maybe((cfg.context_length, d),
                         (1, cfg.context_length, d))
        if folded is None:
            raise WeightError(
                "BERT structural recovery: token-type embedding table "
                f"not found (expected [2, {d}]-class or a folded "
                f"[{cfg.context_length}, {d}] constant)")
        type_tab = np.asarray(folded).reshape(-1, d)[:1]
    params["type_embed"] = np.asarray(type_tab)
    params["pos_embed"] = np.asarray(
        p.pull((n_pos, d), (1, n_pos, d), what="position embeddings")
    ).reshape(-1, d)
    params["embed_ln"] = _pull_ln(p, d)

    blocks = []
    for i in range(cfg.layers):
        blocks.append({
            "attn": {
                "q": _pull_linear(p, d, d, what=f"block{i} q"),
                "k": _pull_linear(p, d, d, what=f"block{i} k"),
                "v": _pull_linear(p, d, d, what=f"block{i} v"),
                "out": _pull_linear(p, d, d, what=f"block{i} attn out"),
            },
            "attn_ln": _pull_ln(p, d),
            "mlp": {
                "fc": _pull_linear(p, d, inter, what=f"block{i} fc"),
                "proj": _pull_linear(p, inter, d, what=f"block{i} proj"),
            },
            "mlp_ln": _pull_ln(p, d),
        })
    params["blocks"] = _stack_blocks(blocks)

    if cfg.pooler == "cls_pooler":
        params["pooler"] = _pull_linear(p, d, d, what="bert pooler")
    if cfg.proj == "mlp":
        # open_clip HFTextEncoder: hidden = (width + embed_dim) // 2,
        # second Linear bias-free
        mid = (d + cfg.embed_dim) // 2
        params["proj"] = {
            "fc": _pull_linear(p, d, mid, what="proj fc"),
            "out": _pull_linear(p, mid, cfg.embed_dim, what="proj out",
                                bias=False),
        }
    elif cfg.proj == "linear":
        params["proj"] = _pull_linear(p, d, cfg.embed_dim, what="proj")
    return params


def _structural_extract(g: OnnxGraph, spec, *, tower: str) -> dict:
    """Recover anonymously-named (constant-folded) weights by shape +
    consumption order against the architecture the config promises.

    Covers the transformer families (classic/timm ViT, EVA02, text
    transformer, HF BERT/RoBERTa, MCT hybrid text), the conv-hybrid
    FastViT/MobileCLIP family (both the constant-folded and unfolded
    torch.onnx forms), ConvNeXt, and ModifiedResNet. Every recovery is
    probe-verified against the graph executor (probe_verify).
    """
    if tower == "visual" and spec.family == "vit":
        return _structural_vit(g, spec.cfg)
    if tower == "visual" and spec.family == "fastvit":
        return _structural_fastvit(g, spec.cfg)
    if tower == "visual" and spec.family == "eva02":
        return _structural_eva02(g, spec.cfg)
    if tower == "visual" and spec.family == "convnext":
        return _structural_convnext(g, spec.cfg)
    if tower == "visual" and spec.family == "resnet":
        return _structural_resnet(g, spec.cfg)
    if tower == "text" and spec.family == "text_transformer":
        return _structural_text(g, spec.cfg)
    if tower == "text" and spec.family == "hf_bert":
        return _structural_bert(g, spec.cfg)
    if tower == "text" and spec.family == "mct":
        return _structural_mct(g, spec.cfg)
    raise WeightError(
        f"This ONNX graph carries constant-folded (anonymous) weight names; "
        f"structural extraction is not supported for family '{spec.family}'. "
        f"Convert the original open_clip checkpoint with pull_weights.py "
        f"instead."
    )


# --------------------------------------------------------------------------
# architecture-dim recovery from exported graphs
# --------------------------------------------------------------------------


def _head_votes(g: OnnxGraph, hidden: int) -> list[int]:
    """Attention head-count votes from the graph's reshape constants.

    Multi-head attention reshapes activations to [..., heads, head_dim];
    torch.onnx builds that shape either as one int64 constant or as a
    Concat of scalar constants (dynamic batch/seq Gathers + a [heads] and
    a [head_dim] Constant node) — scan adjacent value pairs in both forms
    for (h, d) with h·d == hidden."""
    inits = g.initializers
    scalar_const: dict[str, int] = {}
    for op_type, _, outputs, attrs in g.nodes:
        v = attrs.get("value")
        if op_type == "Constant" and outputs \
                and isinstance(v, np.ndarray) and v.dtype.kind in "iu" \
                and v.size == 1:
            scalar_const[outputs[0]] = int(v.reshape(-1)[0])
    votes: list[int] = []

    def scan_pairs(values) -> None:
        for a, b in zip(values[:-1], values[1:]):
            if a is not None and b is not None and a > 0 and b > 0 \
                    and a * b == hidden and a <= 256:
                votes.append(a)

    def scan_shape_const(arr) -> None:
        if not isinstance(arr, np.ndarray) or arr.dtype.kind not in "iu":
            return
        flat = arr.reshape(-1)
        if 2 <= flat.size <= 6:
            scan_pairs([int(x) for x in flat])

    for v in inits.values():
        scan_shape_const(v)
    for op_type, inputs, _, attrs in g.nodes:
        if op_type == "Constant":
            scan_shape_const(attrs.get("value"))
        elif op_type == "Concat" and 2 <= len(inputs) <= 6:
            vals = [scalar_const.get(name) if name not in inits
                    else (int(inits[name].reshape(-1)[0])
                          if inits[name].size == 1 else None)
                    for name in inputs]
            scan_pairs(vals)
    return votes


def _mha_head_votes(g: OnnxGraph, hidden: int) -> list[int]:
    """Head-count votes from torch ``nn.MultiheadAttention`` exports, whose
    attention reshape computes B·H *dynamically* — no static (heads,
    head_dim) pair exists for the adjacent-pair scan. The ``num_heads``
    Python int is the ONLY static scalar in that shape arithmetic,
    appearing as ``Mul(dynamic_batch, H)`` (building B·H) and
    ``Div(dynamic_width, H)`` (building head_dim). Vote any scalar int
    constant H with 1 < H ≤ 256, hidden % H == 0, that multiplies or
    divides a dynamic (non-constant) operand. head_dim itself can never be
    the static side of these ops in a torch export — torch derives it BY
    dividing by num_heads."""
    inits = g.initializers
    scalar_const: dict[str, int] = {}
    for name, arr in inits.items():
        if arr.dtype.kind in "iu" and arr.size == 1:
            scalar_const[name] = int(arr.reshape(-1)[0])
    for op_type, _, outputs, attrs in g.nodes:
        v = attrs.get("value")
        if op_type == "Constant" and outputs \
                and isinstance(v, np.ndarray) and v.dtype.kind in "iu" \
                and v.size == 1:
            scalar_const[outputs[0]] = int(v.reshape(-1)[0])
    votes: list[int] = []
    for op_type, inputs, _, _ in g.nodes:
        if op_type not in ("Mul", "Div") or len(inputs) != 2:
            continue
        a, b = inputs
        static = [scalar_const.get(a), scalar_const.get(b)]
        if (static[0] is None) == (static[1] is None):
            continue  # both dynamic or both static — not the MHA pattern
        c = static[0] if static[0] is not None else static[1]
        if 1 < c <= 256 and c != hidden and hidden % c == 0:
            votes.append(c)
    return votes


def _rope_head_votes(g: OnnxGraph, width: int) -> list[int]:
    """Head-count votes from baked rope tables: a rope-family export
    carries per-position sin/cos constants whose last dim is head_dim
    ([n_pos, head_dim], values in [-1, 1]) — heads = width / head_dim.
    Catches exports whose attention reshape puts the head count next to a
    DYNAMIC head_dim (e.g. ``view(B, S, h, -1)``), invisible to the
    adjacent-pair scan of _head_votes."""
    votes: list[int] = []

    def check(arr) -> None:
        if not (isinstance(arr, np.ndarray) and arr.ndim == 2
                and arr.dtype.kind == "f"):
            return
        d = int(arr.shape[1])
        # n_pos (rows) can be smaller than head_dim at toy scales — the
        # discriminators are the bound (sin/cos ∈ [-1, 1]; weight matrices
        # of trained models exceed it) and the head-divisor last dim
        if (16 <= d < width and width % d == 0 and arr.shape[0] >= 2
                and float(np.abs(arr).max()) <= 1.0 + 1e-4):
            votes.append(width // d)

    for v in g.initializers.values():
        check(v)
    for op_type, _, _, attrs in g.nodes:
        if op_type == "Constant":
            check(attrs.get("value"))
    return votes


def _patch_conv_dims(g: OnnxGraph, onnx_path) -> tuple[int, int]:
    """(width, patch_size) from the [width, 3, p, p] patch conv — the only
    conv in a ViT-class graph consuming 3 input channels."""
    convs = [v for v in g.initializers.values()
             if v.ndim == 4 and v.shape[1] == 3 and v.shape[2] == v.shape[3]
             and v.shape[2] > 1]
    if not convs:
        raise WeightError(
            f"{onnx_path}: cannot locate the [width, 3, p, p] patch conv; "
            "tower dims are not derivable from this graph")
    return int(convs[0].shape[0]), int(convs[0].shape[2])


def _named_layer_count(g: OnnxGraph) -> int:
    layer_ids = {
        int(m.group(1))
        for k in g.initializers
        for m in (re.search(r"(?:blocks|resblocks|layers)\.(\d+)\.", k),)
        if m
    }
    return max(layer_ids) + 1 if layer_ids else 0


def derive_eva02_cfg(onnx_path: Path | str) -> dict:
    """Recover EVA02 per-size dims from the exported visual graph — the
    same self-derivation as :func:`derive_pe_cfg` for the other
    paper-reconstructed size table (models.eva02._EVA02_VARIANTS).

    width/patch from the patch conv; SwiGLU hidden + depth from the 2-D
    shape histogram (each block carries exactly three [width, hidden]-class
    matrices: w_gate, w_x, w_out); heads from the baked rope sin/cos
    constants (head_dim-wide, the family's defining feature); LN epsilon
    from LayerNormalization attributes."""
    g = read_onnx(onnx_path)
    width, patch = _patch_conv_dims(g, onnx_path)

    pair_counts: dict[int, int] = {}
    for v in g.initializers.values():
        if v.ndim == 2 and width in v.shape:
            other = int(v.shape[0] if int(v.shape[1]) == width
                        else v.shape[1])
            if other > width:
                pair_counts[other] = pair_counts.get(other, 0) + 1
    if not pair_counts:
        raise WeightError(
            f"{onnx_path}: no SwiGLU matrices found (is this an EVA02 "
            "graph?)")
    mlp_hidden = max(pair_counts, key=lambda d: pair_counts[d])
    layers = _named_layer_count(g) or pair_counts[mlp_hidden] // 3

    votes = _rope_head_votes(g, width)
    if not votes:
        raise WeightError(
            f"{onnx_path}: no rope tables found to derive the head count "
            "(EVA02 exports bake per-position sin/cos constants)")
    heads = max(set(votes), key=votes.count)

    eps_votes = [float(attrs["epsilon"]) for op, _, _, attrs in g.nodes
                 if op == "LayerNormalization"
                 and isinstance(attrs.get("epsilon"), float)]
    cfg = {
        "width": width,
        "layers": layers,
        "heads": heads,
        "mlp_hidden": mlp_hidden,
    }
    if eps_votes:
        cfg["ln_eps"] = max(set(eps_votes), key=eps_votes.count)
    return cfg


def derive_pe_cfg(onnx_path: Path | str) -> dict:
    """Recover PE-Core per-size dims from the exported visual graph itself
    — the ``derive_bert_hf_config`` pattern for the vision tower whose
    paper-reconstructed size table has no independent in-env anchor
    (models.build._PE_CORE_SIZES). A real exported dir thus loads with
    self-derived dims; the table only seeds models that never came through
    a graph.

    Derivable from any torch export of the tower: width + patch size from
    the [width, 3, p, p] patch conv (the only conv consuming 3 channels),
    MLP width + depth from the 2-D initializer shape histogram (each block
    carries exactly two [width, mlp_hidden]-class matrices; the packed
    [3·width, width] qkv is excluded by shape), the MAP pool's MLP width
    from the remaining once-per-graph pair, the head count from the
    attention reshape constants, and the LN epsilon from
    LayerNormalization attributes. Raises WeightError when the patch conv
    can't be located."""
    g = read_onnx(onnx_path)
    width, patch = _patch_conv_dims(g, onnx_path)

    # depth + MLP width from the 2-D shape histogram. Excluded pair dims:
    # width (square projections), 3·width (packed qkv in_proj), and the
    # embed dim (projection) — what remains is block fc/proj (2 per layer)
    # and the MAP pool's fc/proj (2 per graph).
    pair_counts: dict[int, int] = {}
    for v in g.initializers.values():
        if v.ndim == 2 and width in v.shape:
            other = int(v.shape[0] if int(v.shape[1]) == width
                        else v.shape[1])
            if other > width and other != 3 * width:
                pair_counts[other] = pair_counts.get(other, 0) + 1
    if not pair_counts:
        raise WeightError(
            f"{onnx_path}: no MLP matrices found (is this a ViT graph?)")
    mlp_hidden = max(pair_counts, key=lambda d: pair_counts[d])
    # named per-layer parameters beat shape counting when names survive
    layers = _named_layer_count(g) or pair_counts[mlp_hidden] // 2
    pool_pairs = [d for d, c in pair_counts.items()
                  if d != mlp_hidden and c == 2]
    pool_mlp_hidden = pool_pairs[0] if len(pool_pairs) == 1 else None

    # rope tables are the primary evidence (exact head_dim); reshape-pair
    # votes cover non-rope exports
    votes = _rope_head_votes(g, width) \
        or [h for h in _head_votes(g, width) if h > 1]
    if votes:
        heads = max(set(votes), key=votes.count)
    elif width % 64 == 0:
        heads = width // 64
    else:
        raise WeightError(
            f"{onnx_path}: cannot derive the attention head count "
            f"(no reshape or rope constants, width={width} not "
            "64-divisible)")

    eps_votes = [float(attrs["epsilon"]) for op, _, _, attrs in g.nodes
                 if op == "LayerNormalization"
                 and isinstance(attrs.get("epsilon"), float)]
    cfg = {
        "width": width,
        "patch_size": patch,
        "layers": layers,
        "heads": heads,
        "mlp_hidden": mlp_hidden,
    }
    if pool_mlp_hidden is not None:
        cfg["pool_mlp_hidden"] = pool_mlp_hidden
    if eps_votes:
        cfg["ln_eps"] = max(set(eps_votes), key=eps_votes.count)
    return cfg


def derive_bert_hf_config(onnx_path: Path | str) -> dict:
    """Recover the ``text_cfg.hf_config`` dict for an ``hf_model_name``
    (BERT/RoBERTa-class) text tower from the exported text.onnx itself.

    The reference model-dir contract carries no HF config.json
    (src/model_manager.rs:8-18), so a BiomedCLIP-class ONNX dir (reference
    README.md:143 lists microsoft/BiomedCLIP as tested) arrives without the
    architecture dims models.hf_text.resolve_hf_text needs. Every one of
    them is present in the graph: the embedding tables give vocab / width /
    position count, per-layer parameter names give depth, 2-D weight shapes
    give the MLP width, the transpose-for-scores reshape constants give the
    head count, LayerNormalization attributes give the epsilon, and the
    RoBERTa position-id derivation (CumSum over ``ids != pad``) identifies
    the model type and pad id.

    Raises WeightError when the graph's embedding tables can't be located —
    fully constant-folded anonymous graphs fall back to the generic ONNX
    executor, same as any unknown family.
    """
    g = read_onnx(onnx_path)
    inits = g.initializers

    def by_suffix(suffix: str) -> np.ndarray | None:
        hits = [v for k, v in inits.items() if k.endswith(suffix)]
        return hits[0] if len(hits) == 1 else None

    word = by_suffix("embeddings.word_embeddings.weight")
    pos = by_suffix("embeddings.position_embeddings.weight")
    if word is None or pos is None or word.ndim != 2:
        raise WeightError(
            f"{onnx_path}: cannot locate the BERT embedding tables by name; "
            "hf_config is not derivable from this graph (convert the "
            "original checkpoint with pull_weights.py, or let the generic "
            "ONNX executor run it)"
        )
    vocab, hidden = int(word.shape[0]), int(word.shape[1])
    max_pos = int(pos.shape[0])

    # depth: named per-layer parameters (LN scales survive even the
    # mixed-name exports whose Linear weights fold to onnx::MatMul_*)
    layer_ids = {
        int(m.group(1))
        for k in inits
        for m in (re.search(r"encoder\.layer\.(\d+)\.", k),)
        if m
    }
    layers = max(layer_ids) + 1 if layer_ids else 0

    # MLP width + (fallback) depth from 2-D weight shapes: each block has
    # exactly two [hidden, inter]-shaped matrices (fc + proj, either
    # orientation), and inter is the only repeated non-hidden pair dim
    pair_dims: list[int] = []
    for v in inits.values():
        if v.ndim == 2 and hidden in v.shape:
            other = int(v.shape[0] if int(v.shape[1]) == hidden
                        else v.shape[1])
            if other not in (hidden, vocab, max_pos):
                pair_dims.append(other)
    inter_candidates = [d for d in pair_dims if d > hidden]
    if not inter_candidates:
        raise WeightError(
            f"{onnx_path}: no MLP intermediate matrices found "
            "(is this a BERT-class text graph?)"
        )
    intermediate = max(set(inter_candidates), key=inter_candidates.count)
    if not layers:
        layers = inter_candidates.count(intermediate) // 2

    # head count: transformers' transpose_for_scores reshapes to
    # [..., heads, head_dim] — scan the graph's reshape constants
    head_votes = _head_votes(g, hidden)
    # [1, 1, hidden]-style mask/broadcast reshapes also yield a (1, hidden)
    # pair — prefer multi-head votes (the transpose-for-scores constants
    # recur 2×/layer and dominate any genuine single-head graph anyway)
    multi_votes = [h for h in head_votes if h > 1] or head_votes
    if multi_votes:
        heads = max(set(multi_votes), key=multi_votes.count)
    elif hidden % 64 == 0:
        heads = hidden // 64  # transformers-wide convention
    else:
        raise WeightError(
            f"{onnx_path}: cannot derive the attention head count "
            f"(no reshape constants, hidden={hidden} not 64-divisible)"
        )

    # model type: RoBERTa position ids come from
    # create_position_ids_from_input_ids = CumSum(ids != pad) + pad
    roberta = any(op == "CumSum" for op, _, _, _ in g.nodes)

    # pad id: open_clip's HFTextEncoder derives the mask IN-graph as
    # ``ids != pad_token_id`` (the exported tower takes only input_ids,
    # reference: pull_onnx.py:62-68 wraps encode_text) — the comparison's
    # scalar int constant is the pad id, for BERT and RoBERTa alike
    const_outputs: dict[str, np.ndarray] = {}
    for op_type, _, outputs, attrs in g.nodes:
        if op_type == "Constant" and outputs \
                and isinstance(attrs.get("value"), np.ndarray):
            const_outputs[outputs[0]] = attrs["value"]
    pad_votes: list[int] = []
    for op_type, inputs, _, _ in g.nodes:
        if op_type in ("Equal", "NotEqual"):
            for name in inputs:
                c = inits.get(name)
                if c is None:
                    c = const_outputs.get(name)
                if c is not None and c.dtype.kind in "iu" and c.size == 1:
                    pad_votes.append(int(c.reshape(-1)[0]))
    pad_id = (max(set(pad_votes), key=pad_votes.count) if pad_votes
              else (1 if roberta else 0))

    eps_votes: list[float] = []
    for op_type, _, _, attrs in g.nodes:
        if op_type == "LayerNormalization" \
                and isinstance(attrs.get("epsilon"), float):
            eps_votes.append(float(attrs["epsilon"]))
    if not eps_votes:
        # decomposed LN: the epsilon rides an Add with a tiny scalar const
        for v in inits.values():
            if v.dtype.kind == "f" and v.size == 1 \
                    and 0.0 < float(v.reshape(-1)[0]) <= 1e-3:
                eps_votes.append(float(v.reshape(-1)[0]))
    eps = (max(set(eps_votes), key=eps_votes.count) if eps_votes
           else (1e-5 if roberta else 1e-12))

    return {
        "vocab_size": vocab,
        "hidden_size": hidden,
        "num_attention_heads": heads,
        "num_hidden_layers": layers,
        "intermediate_size": intermediate,
        "pad_token_id": pad_id,
        "layer_norm_eps": eps,
        "model_type": "xlm-roberta" if roberta else "bert",
        "max_position_embeddings": max_pos,
    }


def derive_mct_cfg(onnx_path: Path | str) -> dict:
    """Recover the hybrid-text (MobileCLIP ``mct``-class) architecture from
    the exported text.onnx itself.

    The family has no in-env source of truth (COMPONENTS.md honesty note),
    so — like ``derive_bert_hf_config`` — every structural parameter comes
    from the graph: embedding tables give vocab/width/context, depthwise
    1-D Conv nodes give the token-mixer count and kernel sizes, the 2-D
    initializers consumed between mixers give each block's ConvFFN hidden
    dim, Softmax nodes give the transformer depth, reshape constants give
    the head count, a square big-negative mask constant (or Trilu) gives
    causality, and an ArgMax node distinguishes CLIP argmax-EOT pooling
    from last-token pooling. The converted tower is additionally
    SELF-VERIFIED against the generic ONNX executor on the same graph at
    load time (text.py), so a graph this derivation misreads falls back to
    the executor instead of producing wrong embeddings.

    Raises WeightError when the graph is not a conv+attention hybrid text
    tower of the supported prefix form (all conv mixers before the first
    attention block).
    """
    g = read_onnx(onnx_path)
    inits = g.initializers
    const_outputs: dict[str, np.ndarray] = {}
    for op_type, _, outputs, attrs in g.nodes:
        if op_type == "Constant" and outputs \
                and isinstance(attrs.get("value"), np.ndarray):
            const_outputs[outputs[0]] = attrs["value"]

    def lookup(name: str) -> np.ndarray | None:
        arr = inits.get(name)
        return arr if arr is not None else const_outputs.get(name)

    # token embedding: the first 2-D tensor a Gather indexes into
    emb = None
    for op_type, inputs, _, _ in g.nodes:
        if op_type == "Gather" and inputs:
            cand = lookup(inputs[0])
            if cand is not None and cand.ndim == 2:
                emb = cand
                break
    if emb is None:
        raise WeightError(
            f"{onnx_path}: no token-embedding Gather — not a text tower")
    vocab, width = int(emb.shape[0]), int(emb.shape[1])

    # positional table: an Add operand with trailing dim == width and a
    # leading product that is neither 1 nor the vocab size
    ctx = None
    for op_type, inputs, _, _ in g.nodes:
        if op_type != "Add":
            continue
        for name in inputs:
            c = lookup(name)
            if c is not None and c.ndim >= 2 and int(c.shape[-1]) == width:
                t = int(np.prod(c.shape[:-1]))
                if 1 < t != vocab:
                    ctx = t
                    break
        if ctx:
            break
    if ctx is None:
        raise WeightError(f"{onnx_path}: no positional-embedding Add")

    # node-order events
    dw_events: list[tuple[int, int]] = []   # (node idx, kernel)
    softmax_idx: list[int] = []
    has_argmax = False
    ops_seen: set[str] = set()
    first_consumer: dict[str, int] = {}
    ln_eps_votes: list[float] = []
    for idx, (op_type, inputs, _, attrs) in enumerate(g.nodes):
        ops_seen.add(op_type)
        for name in inputs:
            if name in inits and name not in first_consumer:
                first_consumer[name] = idx
        if op_type == "Conv" and len(inputs) > 1:
            w = inits.get(inputs[1])
            if w is not None and w.ndim == 3 and int(w.shape[1]) == 1 \
                    and int(w.shape[0]) == width \
                    and int(attrs.get("group", 1)) == width:
                k = int(w.shape[2])
                # mct._dwconv1d implements symmetric SAME padding only; a
                # causal (left-only) or VALID export is a numerically
                # different tower — reject here (with the reason logged)
                # instead of converting something probe_verify will bounce
                pads = list(attrs.get("pads") or [0, 0])
                auto = attrs.get("auto_pad", b"NOTSET")
                same = pads == [k // 2] * 2 or (
                    k % 2 == 1 and auto in (b"SAME_UPPER", b"SAME_LOWER"))
                if not same:
                    from .utils.logging import warn_once

                    warn_once(
                        f"mct_pads:{onnx_path}",
                        "%s: depthwise conv mixer uses non-symmetric "
                        "padding pads=%s (kernel %d) — not liftable to the "
                        "native mct tower; the graph serves via the "
                        "executor", str(onnx_path), pads, k)
                    raise WeightError(
                        f"{onnx_path}: non-symmetric dw-conv padding "
                        f"pads={pads} (kernel {k})")
                dw_events.append((idx, k))
        elif op_type == "Softmax":
            softmax_idx.append(idx)
        elif op_type == "ArgMax":
            has_argmax = True
        elif op_type == "LayerNormalization" \
                and isinstance(attrs.get("epsilon"), float):
            ln_eps_votes.append(float(attrs["epsilon"]))
    if not dw_events:
        raise WeightError(
            f"{onnx_path}: no depthwise 1-D conv mixers — not an MCT-class "
            "hybrid (plain transformers take the native text_transformer "
            "path)")
    if not softmax_idx:
        raise WeightError(f"{onnx_path}: no attention layers")
    first_sm = softmax_idx[0]
    if any(i > first_sm for i, _ in dw_events):
        raise WeightError(
            f"{onnx_path}: conv mixers interleaved with attention blocks — "
            "only the conv-prefix hybrid form is supported natively")

    # 2-D linear initializers by (consumer idx, non-width pair dim)
    banned = {width, 3 * width}
    pair_at: list[tuple[int, int]] = []
    for name, arr in inits.items():
        if arr.ndim != 2 or name not in first_consumer:
            continue
        dims = (int(arr.shape[0]), int(arr.shape[1]))
        if width not in dims:
            continue
        other = dims[0] if dims[1] == width else dims[1]
        if arr.shape == emb.shape and np.shares_memory(arr, emb):
            continue
        pair_at.append((first_consumer[name], other))

    # ConvFFN hidden per mixer block: linears consumed between this dw conv
    # and the next (last block: up to the first Softmax), excluding
    # attention-shaped (width/3·width) weights
    conv_blocks: list[tuple[int, int]] = []
    bounds = [i for i, _ in dw_events] + [first_sm]
    for b, (idx, kernel) in enumerate(dw_events):
        hs = [other for at, other in pair_at
              if bounds[b] < at < bounds[b + 1] and other not in banned
              and other != vocab]
        ffn_hidden = max(set(hs), key=hs.count) if hs else 0
        conv_blocks.append((kernel, ffn_hidden))

    # transformer MLP hidden: most common non-attention pair dim consumed
    # after the first Softmax (each layer contributes fc + proj = 2 votes)
    mlp_votes = [other for at, other in pair_at
                 if at > first_sm and other not in banned and other != vocab]
    layers = len(softmax_idx)
    if not mlp_votes:
        raise WeightError(f"{onnx_path}: no transformer MLP weights found")
    mlp_hidden = max(set(mlp_votes), key=mlp_votes.count)

    head_votes = [h for h in _head_votes(g, width) if h > 1]
    if not head_votes:
        # nn.MultiheadAttention exports build B·H dynamically — fall back
        # to the Mul/Div-by-num_heads signature
        head_votes = [h for h in _mha_head_votes(g, width) if h > 1]
    if head_votes:
        heads = max(set(head_votes), key=head_votes.count)
    elif width % 64 == 0:
        heads = width // 64
    else:
        raise WeightError(f"{onnx_path}: cannot derive the head count")

    # causality: an explicit [S, S] additive mask constant with -inf/-1e4
    # rows, or a Trilu node building one
    causal = "Trilu" in ops_seen
    if not causal:
        for arr in list(inits.values()) + list(const_outputs.values()):
            if arr.ndim >= 2 and arr.shape[-1] == arr.shape[-2] \
                    and arr.shape[-1] > 1 and arr.dtype.kind == "f" \
                    and np.isfinite(arr).any() \
                    and float(np.nanmin(arr)) <= -1e4:
                causal = True
                break

    # projection: the LAST-consumed 2-D initializer with a width dim is the
    # text projection; its other dim is the embed dim
    last_at, embed_dim = max(pair_at, key=lambda t: t[0])
    if embed_dim in (vocab,):
        raise WeightError(f"{onnx_path}: trailing projection not found")

    if "Erf" in ops_seen:
        activation = "gelu"
    elif "Tanh" in ops_seen:
        activation = "gelu_tanh"
    elif "Sigmoid" in ops_seen:
        activation = "quick_gelu"
    elif "Relu" in ops_seen:
        activation = "relu"
    else:
        activation = "gelu"

    eps = (max(set(ln_eps_votes), key=ln_eps_votes.count)
           if ln_eps_votes else 1e-5)

    return {
        "context_length": ctx,
        "vocab_size": vocab,
        "width": width,
        "heads": heads,
        "layers": layers,
        "mlp_hidden": mlp_hidden,
        "embed_dim": embed_dim,
        "conv_blocks": tuple(conv_blocks),
        "activation": activation,
        "causal": causal,
        "pool": "argmax" if has_argmax else "last",
        "ln_eps": eps,
    }


def _pull_conv1d(p: _Puller, c: int, k: int, *, what: str) -> dict:
    """Pull a depthwise Conv1d (ONNX [C, 1, k]) → {"w": [k, C], "b": [C]},
    folding an immediately-following live BatchNormalization when the conv
    is bias-free (same gate as _pull_conv's 2-D variant)."""
    w = p.pull((c, 1, k), what=what or "conv1d")
    out = {"w": np.ascontiguousarray(
        np.asarray(w)[:, 0, :].T)}                       # [k, C]
    b = p.maybe((c,), consumer_ops=("Conv",), lookahead=1)
    out["b"] = b if b is not None else np.zeros(c, np.float32)
    bn_scale = None if b is not None else p.maybe(
        (c,), consumer_ops=("BatchNormalization",), lookahead=1)
    if bn_scale is not None:
        from .weights import fold_bn_affine

        eps = float(p.consumers.get(p.last_name or "",
                                    ("", {}))[1].get("epsilon", 1e-5))
        bn_b = p.pull((c,), what=f"{what} bn bias",
                      consumer_ops=("BatchNormalization",), lookahead=1)
        mean = p.pull((c,), what=f"{what} bn mean",
                      consumer_ops=("BatchNormalization",), lookahead=1)
        var = p.pull((c,), what=f"{what} bn var",
                     consumer_ops=("BatchNormalization",), lookahead=1)
        scale, bias = fold_bn_affine(bn_scale, bn_b, mean, var, eps=eps)
        out["w"] = (out["w"] * scale[None, :]).astype(np.float32)
        out["b"] = (np.asarray(out["b"], np.float64) * scale
                    + bias).astype(np.float32)
    return out


def _structural_mct(g: OnnxGraph, cfg) -> dict:
    """MCT-class hybrid text recovery by consumption order: token/pos
    embeddings → per conv block (dw conv [+bn] → [ln → fc → proj]) →
    text-transformer blocks (same pulls as _structural_text) → ln_final →
    projection. The load path self-verifies the result against the ONNX
    executor (text.py), so a consumption-order misread cannot ship."""
    from .weights import _split_qkv, _stack_blocks

    p = _Puller(g)
    d = cfg.width
    params: dict = {
        "token_embed": p.pull((cfg.vocab_size, d), what="token embedding"),
        "pos_embed": np.asarray(
            p.pull((cfg.context_length, d), (1, cfg.context_length, d),
                   what="pos embed")).reshape(cfg.context_length, d),
    }
    conv_blocks = []
    for i, (k, ffn_hidden) in enumerate(cfg.conv_blocks):
        block: dict = {"mixer": _pull_conv1d(p, d, k, what=f"conv{i} dw")}
        if ffn_hidden:
            block["ffn"] = {
                "ln": _pull_ln(p, d),
                "fc": _pull_linear(p, d, ffn_hidden, what=f"conv{i} fc"),
                "proj": _pull_linear(p, ffn_hidden, d, what=f"conv{i} proj"),
            }
        conv_blocks.append(block)
    params["conv_blocks"] = conv_blocks

    blocks = []
    for i in range(cfg.layers):
        block = {"ln1": _pull_ln(p, d)}
        attn: dict = {}
        qkv = _maybe_packed(p, (3 * d, d), (d, 3 * d))
        if qkv is not None:
            w = qkv if qkv.shape == (3 * d, d) else qkv.T
            attn = _split_qkv(np.ascontiguousarray(w),
                              p.maybe((3 * d,), lookahead=4))
        else:
            attn["q"] = _pull_linear(p, d, d, what=f"block{i} q")
            attn["k"] = _pull_linear(p, d, d, what=f"block{i} k")
            attn["v"] = _pull_linear(p, d, d, what=f"block{i} v")
        attn["out"] = _pull_linear(p, d, d, what=f"block{i} attn out")
        block["attn"] = attn
        block["ln2"] = _pull_ln(p, d)
        block["mlp"] = {
            "fc": _pull_linear(p, d, cfg.mlp_hidden, what=f"block{i} fc"),
            "proj": _pull_linear(p, cfg.mlp_hidden, d,
                                 what=f"block{i} proj"),
        }
        blocks.append(block)
    params["blocks"] = _stack_blocks(blocks)
    params["ln_final"] = _pull_ln(p, d)
    params["proj"] = _pull_linear(p, d, cfg.embed_dim, what="text proj",
                                  bias=cfg.proj_bias)
    return params


def derive_fastvit_cfg(onnx_path: Path | str) -> dict:
    """Recover the FastViT/MCi stage architecture from the exported visual
    graph itself — the ``derive_pe_cfg`` pattern for the conv-hybrid family
    whose MCi3/MCi4 rows in models.fastvit._FASTVIT_VARIANTS are
    structure-from-paper with no independent in-env anchor (COMPONENTS.md
    evidence table). A real exported dir (the form the reference publishes,
    README.md:106-113) thus loads with self-derived dims; the table only
    seeds models that never came through a graph.

    Every stage parameter is present in the graph's ordered Conv events
    (weight shapes + ``group``/``strides`` attributes) and Softmax markers,
    in timm's reparameterized forward order:

      stem (conv3 s2 → dw3 s2 → pw1) → per stage: [downsample dw7 *s2* →
      pw1] [RepCPE dw7 s1 before any block marker] → blocks (RepMixer:
      mixer dw3 s1 then FFN dw7 s1 → fc1 pw → fc2 pw; Attention: Softmax
      then the same FFN triple) → final grouped conv3 → GAP → head.

    The stride distinguishes the three dw7 roles' only collision
    (downsample s2 vs FFN/CPE s1); a s1 dw7 before the stage's first block
    marker is the CPE (FFN dw7 can only follow a mixer or a Softmax).
    ``lkc_act`` (MCi applies gelu after the downsample dw conv) is read
    from the presence of an activation node between the downsample's dw
    and pw convs. Head count comes from the attention reshape constants
    ([3, heads, head_dim] is static in timm's qkv reshape).

    Raises WeightError when the graph is not a FastViT-shaped conv tower.
    """
    g = read_onnx(onnx_path)
    const_w: dict[str, np.ndarray] = {}
    for op_type, _, outputs, attrs in g.nodes:
        if op_type == "Constant" and outputs \
                and isinstance(attrs.get("value"), np.ndarray):
            const_w[outputs[0]] = attrs["value"]

    # ordered conv / softmax / activation events
    events: list[tuple] = []   # ("conv", out, in_total, k, groups, stride)
    act_idx: list[int] = []
    for idx, (op_type, inputs, _, attrs) in enumerate(g.nodes):
        if op_type == "Softmax":
            events.append(("softmax", idx))
        elif op_type in ("Erf", "Gelu", "Sigmoid", "Tanh", "Relu"):
            act_idx.append(idx)
        elif op_type == "Conv" and len(inputs) > 1:
            w = g.initializers.get(inputs[1])
            if w is None:
                w = const_w.get(inputs[1])
            if w is None or w.ndim != 4:
                continue
            o, ipg, kh, kw = (int(s) for s in w.shape)
            grp = int(attrs.get("group", 1))
            st = int((attrs.get("strides") or [1, 1])[0])
            if kh != kw:
                raise WeightError(
                    f"{onnx_path}: non-square conv kernel {kh}x{kw}")
            events.append(("conv", idx, o, ipg * grp, kh, grp, st))

    convs = [e for e in events if e[0] == "conv"]
    if len(convs) < 5 or convs[0][3] != 3:
        raise WeightError(
            f"{onnx_path}: no RGB stem conv — not a FastViT-class graph")
    c0 = convs[0][2]
    if not (convs[1][2] == c0 and convs[1][5] == c0 and convs[1][4] == 3
            and convs[2][2] == c0 and convs[2][4] == 1):
        raise WeightError(
            f"{onnx_path}: stem is not conv3/dw3/pw1 at width {c0}")

    # walk post-stem events, segmenting stages
    stem_end = events.index(convs[2])
    depths: list[int] = []
    dims: list[int] = [c0]
    hiddens: list[int] = []
    mixers: list[str] = []
    pos_embs: list[bool] = []
    cur = c0
    depth = 0
    saw_attn = False
    saw_cpe = False
    hidden = 0
    final_conv_out = None
    use_head_proj = False
    lkc_act = False

    def close_stage():
        nonlocal depth, saw_attn, saw_cpe, hidden
        if depth == 0:
            raise WeightError(f"{onnx_path}: empty FastViT stage")
        depths.append(depth)
        mixers.append("attention" if saw_attn else "repmixer")
        pos_embs.append(saw_cpe)
        hiddens.append(hidden)
        depth, saw_attn, saw_cpe, hidden = 0, False, False, 0

    i = stem_end + 1
    n = len(events)
    while i < n:
        ev = events[i]
        if ev[0] == "softmax":
            saw_attn = True
            depth += 1
            i += 1
            continue
        _, idx, o, in_total, k, grp, st = ev
        if k == 7 and grp == cur and in_total == cur and st == 2:
            # downsample: dw7 s2 → pw1 to the next stage width
            close_stage()
            j = i + 1
            while j < n and events[j][0] != "conv":
                j += 1
            if j >= n or events[j][4] != 1 or events[j][3] != cur:
                raise WeightError(
                    f"{onnx_path}: downsample dw7 not followed by a pw1")
            lkc_act = lkc_act or any(idx < a < events[j][1]
                                     for a in act_idx)
            cur = events[j][2]
            dims.append(cur)
            i = j + 1
            continue
        if k == 7 and grp == cur and in_total == cur and st == 1:
            if depth == 0 and not saw_attn and hidden == 0:
                # stage entry, before any block marker → RepCPE
                saw_cpe = True
                i += 1
                continue
            # FFN triple: dw7 → fc1 pw (hidden←cur) → fc2 pw (cur←hidden)
            pws = []
            j = i + 1
            while j < n and len(pws) < 2:
                if events[j][0] == "conv":
                    if events[j][4] != 1:
                        break
                    pws.append(events[j])
                j += 1
            if len(pws) != 2 or pws[0][3] != cur or pws[1][2] != cur \
                    or pws[0][2] != pws[1][3]:
                raise WeightError(
                    f"{onnx_path}: ConvFFN dw7 at width {cur} not followed "
                    "by an expand/project pw pair")
            hidden = pws[0][2]
            i = j
            continue
        if k == 3 and grp == cur and in_total == cur and o == cur and st == 1:
            # RepMixer token mixer
            depth += 1
            i += 1
            continue
        if k == 3 and grp == cur and in_total == cur and o != cur:
            # final expand conv (grouped, out = ratio·cur)
            final_conv_out = o
            i += 1
            continue
        raise WeightError(
            f"{onnx_path}: unexpected conv event (out={o}, in={in_total}, "
            f"k={k}, groups={grp}, stride={st}) at width {cur} — not a "
            "FastViT-shaped graph")
    close_stage()
    if final_conv_out is None:
        raise WeightError(f"{onnx_path}: no final expand conv found")

    # trailing head projection: a 2-D matrix with a final_conv_out dim
    for arr in list(g.initializers.values()) + list(const_w.values()):
        if arr.ndim == 2 and final_conv_out in arr.shape:
            use_head_proj = True
            break

    cfg = {
        "depths": tuple(depths),
        "dims": tuple(dims),
        "mlp_ratios": tuple(h / d for h, d in zip(hiddens, dims)),
        "mixers": tuple(mixers),
        "pos_embs": tuple(pos_embs),
        "final_conv_ratio": final_conv_out / dims[-1],
        "use_head_proj": use_head_proj,
        "lkc_act": lkc_act,
    }
    attn_dims = [d for d, m in zip(dims, mixers) if m == "attention"]
    if attn_dims:
        votes = [h for h in _head_votes(g, attn_dims[-1]) if h > 1]
        if not votes:
            # the Mul/Div-by-num_heads fallback can mis-vote on vision
            # graphs (spatial-shape arithmetic is full of small static
            # ints multiplying dynamic operands), so require the implied
            # head_dim to be a plausible attention width — a power of two
            # in [16, 128], which covers every timm FastViT/MCi variant.
            # A surviving mis-vote is still caught by probe_verify at
            # load time (the persisted cfg then fails the executor
            # cross-check and the dir serves via the executor).
            votes = [h for h in _mha_head_votes(g, attn_dims[-1])
                     if h > 1 and (hd := attn_dims[-1] // h) >= 16
                     and hd <= 128 and hd & (hd - 1) == 0]
        if votes:
            heads = max(set(votes), key=votes.count)
            cfg["head_dim"] = attn_dims[-1] // heads
    return cfg
