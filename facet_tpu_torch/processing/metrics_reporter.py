"""Throttled progress reporting (reference: processing/metrics_reporter.py).

Prints `[n/N] img/s | MB/s | mem | queue stalls | workers | batch` lines at
most every few seconds plus a final summary with peaks.
"""

import time

import psutil


class MetricsReporter:
    def __init__(self, total, interval_seconds=5.0, label="scan"):
        self.total = total
        self.interval = interval_seconds
        self.label = label
        self.start = time.time()
        self.last_print = 0.0
        self.processed = 0
        self.bytes_read = 0
        self.queue_stalls = 0
        self.peak_mem_percent = 0.0
        self.peak_rate = 0.0

    def update(self, processed=None, add_bytes=0, queue_stalls=None,
               workers=None, batch_size=None):
        if processed is not None:
            self.processed = processed
        self.bytes_read += add_bytes
        if queue_stalls is not None:
            self.queue_stalls = queue_stalls
        now = time.time()
        mem = psutil.virtual_memory().percent
        self.peak_mem_percent = max(self.peak_mem_percent, mem)
        if now - self.last_print < self.interval:
            return
        self.last_print = now
        elapsed = max(now - self.start, 1e-6)
        rate = self.processed / elapsed
        self.peak_rate = max(self.peak_rate, rate)
        mbps = self.bytes_read / elapsed / (1024 * 1024)
        extras = ""
        if workers is not None:
            extras += f" | W {workers}"
        if batch_size is not None:
            extras += f" | batch {batch_size}"
        print(f"[{self.processed}/{self.total}] {rate:.1f} img/s"
              f" | {mbps:.1f} MB/s | mem {mem:.0f}%"
              f" | stalls {self.queue_stalls}{extras}", flush=True)

    def summary(self, phase_times=None, cache_stats=None):
        elapsed = max(time.time() - self.start, 1e-6)
        rate = self.processed / elapsed
        print(f"{self.label} complete: {self.processed}/{self.total} photos"
              f" in {elapsed:.1f}s ({rate:.2f} img/s,"
              f" peak {max(self.peak_rate, rate):.2f} img/s,"
              f" peak mem {self.peak_mem_percent:.0f}%)")
        if phase_times:
            parts = ", ".join(f"{k} {v:.1f}s" for k, v in phase_times.items())
            print(f"  phases: {parts}")
        if cache_stats:
            print(f"  model RAM cache: {cache_stats['hits']} hits /"
                  f" {cache_stats['misses']} misses"
                  f" ({cache_stats['hit_rate'] * 100:.0f}%)")
        return {"elapsed": elapsed, "images_per_second": rate}
