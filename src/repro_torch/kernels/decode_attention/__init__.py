from .ops import (SOURCE, flash_decode, flash_decode_plain, paged_flash_decode,
                  paged_flash_decode_plain, paged_gather)

__all__ = ["SOURCE", "flash_decode", "flash_decode_plain",
           "paged_flash_decode", "paged_flash_decode_plain", "paged_gather"]
