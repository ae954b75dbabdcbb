"""datacomp: a chunked canonical-Huffman compression framework.

JAX/XLA re-architecture of the capabilities of the Java/TornadoVM reference
"DataComp"
(vuyraj/Data-Compression-Implementing-GPU-Driven-Huffman-Encoding-in-Java):
chunked canonical Huffman compression with a bit-compatible `.dcz` footer-last
container, SHA-256 integrity, CLI, per-stage metrics, CPU↔GPU service
selection, and a benchmark suite — scaled across GPUs and hosts via
`jax.sharding` data parallelism over chunks.
"""

__version__ = "0.1.0"
