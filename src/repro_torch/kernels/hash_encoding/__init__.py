from repro_torch.kernels.hash_encoding.ops import (hash_encode,
                                                   hash_encode_batched,
                                                   hash_encode_cuda)

__all__ = ["hash_encode", "hash_encode_batched", "hash_encode_cuda"]
