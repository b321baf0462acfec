"""Models of the port: the LLaMA decoder (``llama``), the BERT/ERNIE
encoder (``bert``) and the numpy bridge from the JAX package
(``convert``)."""

from . import bert, convert, llama

__all__ = ["bert", "convert", "llama"]
