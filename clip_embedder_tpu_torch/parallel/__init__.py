"""Scale-out layer: mesh construction, shardings, bulk embedding, search.

Counterpart of ``clip_embedder_tpu.parallel``. The reference's only
parallelism is host-side (rayon preprocess threads, a shared session, a
manual ``duplicate()`` replica — reference: src/vision.rs:128-132,
src/onnx.rs:9, src/clip.rs:69-73). Here: data parallelism over a mesh of
devices that one process owns (replicated weights, each batch shard on its
device), tensor parallelism over a 'model' axis for the largest towers, a
decode-overlapped bulk pipeline and a row-sharded corpus index.

    mesh = get_mesh()                                     # every visible card
    mesh = get_mesh(devices=["cuda:0"] * 2)               # two shards, one card
    mesh = get_mesh(devices=["cpu"] * 8, model_parallel=2)  # a CPU mesh, 4 x 2
"""

from .mesh import get_mesh, replicate, select_platform, shard_batch
from .sharding import tp_param_specs
from .embed import ShardedVisionEmbedder, ShardedTextEmbedder
from .pipeline import EmbedPipeline
from .search import CorpusIndex

__all__ = [
    "get_mesh",
    "replicate",
    "select_platform",
    "shard_batch",
    "tp_param_specs",
    "ShardedVisionEmbedder",
    "ShardedTextEmbedder",
    "EmbedPipeline",
    "CorpusIndex",
]
