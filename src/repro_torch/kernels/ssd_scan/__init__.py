from .ops import SOURCE, ssd_scan, ssd_scan_plain

__all__ = ["SOURCE", "ssd_scan", "ssd_scan_plain"]
