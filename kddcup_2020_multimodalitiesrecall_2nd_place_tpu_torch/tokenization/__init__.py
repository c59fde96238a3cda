from .wordpiece import BasicTokenizer, FullTokenizer, WordpieceTokenizer, load_vocab

__all__ = ["BasicTokenizer", "FullTokenizer", "WordpieceTokenizer", "load_vocab"]
