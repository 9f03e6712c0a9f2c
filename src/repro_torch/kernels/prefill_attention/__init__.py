from .ops import (SOURCE, flash_scan, paged_flash_prefill,
                  paged_flash_prefill_plain)

__all__ = ["SOURCE", "flash_scan", "paged_flash_prefill",
           "paged_flash_prefill_plain"]
