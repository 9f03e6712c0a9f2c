from .ops import (SOURCE, decode_splits, flash_decode, flash_decode_plain,
                  flash_decode_split_plain, paged_flash_decode,
                  paged_flash_decode_plain, paged_gather)

__all__ = ["SOURCE", "decode_splits", "flash_decode", "flash_decode_plain",
           "flash_decode_split_plain", "paged_flash_decode",
           "paged_flash_decode_plain", "paged_gather"]
