"""Percentile normalization + the scoring-health recommendation engine.

(reference: config/percentile_normalizer.py — the largest config component)

(a) Percentile normalization: raw metrics (Laplacian variance, color entropy,
    eye sharpness) have library-dependent scales; normalized score =
    min(10, raw / P_target * 10) where P_target is the configured percentile
    of the library's raw values — global, or per-category when a category has
    enough samples. Applied during --recompute-average.

(b) Recommendation engine (--compute-recommendations): analyzes the scored
    library for scoring-health issues (ceiling-compressed aesthetics, one
    metric dominating the aggregate, clustered scores, over-generous
    exposure), proposes damped config changes (max +-3 points per run),
    refuses to re-propose a change that history shows was recently reverted
    (A -> B -> A oscillation), and can simulate or apply them (with a config
    backup).

(c) recalculate_batch_settings: the IO-vs-device bottleneck tuner used by the
    streaming processor's calibration phase.
"""

import shutil
import time

import numpy as np

from facet_tpu_torch.db.connection import get_connection

# raw metric column -> the score column it normalizes into (applied during
# --recompute-average)
RAW_METRICS = {
    "raw_sharpness_variance": "tech_sharpness",
    "raw_color_entropy": "color_score",
    "raw_eye_sharpness": "eye_sharpness",
}

# all columns percentiles are computed for (reference tracks 5:
# percentile_normalizer.py:38-42 — histogram_spread and mean_luminance feed
# the recommendation analysis even though no score column rewrites from them)
PERCENTILE_METRICS = list(RAW_METRICS) + ["histogram_spread", "mean_luminance"]

# metrics whose expectations genuinely differ by category (reference
# CATEGORY_NORMALIZED_METRICS: macro vs landscape sharpness, night spread...)
CATEGORY_NORMALIZED_METRICS = [
    "raw_sharpness_variance",
    "raw_color_entropy",
    "histogram_spread",
    "raw_eye_sharpness",
]

DAMPING_MAX_POINTS = 3       # max weight-percent change per run
OSCILLATION_WINDOW = 5       # history entries examined per target


class PercentileNormalizer:
    def __init__(self, db_path, config):
        self.db_path = db_path
        self.config = config
        settings = config.get_normalization_settings()
        self.method = settings.get("method", "percentile")
        self.target = settings.get("percentile_target", 95)
        self.per_category = settings.get("per_category", True)
        self.min_samples = settings.get("category_min_samples", 50)
        self._global = {}
        self._by_category = {}

    # ------------------------------------------------------- percentiles

    def _pick(self, values):
        """Reference percentile semantics (percentile_normalizer.py:55-57):
        nearest-rank selection `sorted[int(n * target / 100)]`, NOT linear
        interpolation — np.percentile diverges by up to one sample step,
        which breaks recompute parity."""
        values = sorted(values)
        idx = min(int(len(values) * self.target / 100), len(values) - 1)
        return float(values[idx])

    def compute_percentiles(self):
        """Global P_target per tracked metric."""
        with get_connection(self.db_path) as conn:
            for raw_col in PERCENTILE_METRICS:
                values = [r[0] for r in conn.execute(
                    f"SELECT {raw_col} FROM photos WHERE {raw_col} IS NOT NULL"
                    f" AND typeof({raw_col}) IN ('real', 'integer')")]
                if values:
                    self._global[raw_col] = self._pick(values)
        return self._global

    def compute_percentiles_per_category(self):
        # reference semantics: a category qualifies per METRIC when it has
        # >= min_samples non-null values of that metric
        with get_connection(self.db_path) as conn:
            for raw_col in CATEGORY_NORMALIZED_METRICS:
                categories = [r[0] for r in conn.execute(
                    f"SELECT category FROM photos WHERE {raw_col} IS NOT NULL"
                    " AND category IS NOT NULL GROUP BY category"
                    " HAVING COUNT(*) >= ?", (self.min_samples,))]
                for category in categories:
                    values = [r[0] for r in conn.execute(
                        f"SELECT {raw_col} FROM photos WHERE category = ?"
                        f" AND {raw_col} IS NOT NULL"
                        f" AND typeof({raw_col}) IN ('real', 'integer')",
                        (category,))]
                    if values:
                        self._by_category.setdefault(category, {})[
                            raw_col] = self._pick(values)
        return self._by_category

    def normalize(self, raw_col, raw_value, category=None):
        """raw value -> 0-10 score using the library percentiles."""
        if raw_value is None:
            return None
        p = None
        if category and self.per_category:
            p = self._by_category.get(category, {}).get(raw_col)
        if p is None:
            p = self._global.get(raw_col)
        if not p or p <= 0:
            return None
        return float(min(10.0, raw_value / p * 10.0))

    def ready(self):
        return bool(self._global)

    # ---------------------------------------------------------- analysis

    def _load_rows(self):
        with get_connection(self.db_path) as conn:
            return [dict(r) for r in conn.execute(
                "SELECT aggregate, aesthetic, exposure_score, tech_sharpness,"
                " color_score, comp_score, contrast_score, quality_score,"
                " face_quality, category"
                " FROM photos WHERE aggregate IS NOT NULL")]

    @staticmethod
    def _correlation(xs, ys):
        xs, ys = np.asarray(xs, float), np.asarray(ys, float)
        if len(xs) < 3 or xs.std() == 0 or ys.std() == 0:
            return None
        return float(np.corrcoef(xs, ys)[0, 1])

    @staticmethod
    def _spearman(xs, ys):
        """Rank correlation (average ranks for ties) — captures monotonic,
        not just linear, metric->aggregate relationships (reference:
        percentile_normalizer.py:193-224)."""
        xs, ys = np.asarray(xs, float), np.asarray(ys, float)
        if len(xs) < 3:
            return None

        def rank(v):
            order = np.argsort(v, kind="stable")
            ranks = np.empty(len(v))
            sv = v[order]
            i = 0
            while i < len(v):
                j = i
                while j + 1 < len(v) and sv[j + 1] == sv[i]:
                    j += 1
                ranks[order[i:j + 1]] = (i + j) / 2 + 1
                i = j + 1
            return ranks

        return PercentileNormalizer._correlation(rank(xs), rank(ys))

    def _metric_correlation(self, xs, ys):
        """Spearman for big samples (robust to nonlinearity), Pearson below."""
        return self._spearman(xs, ys) if len(xs) > 100 \
            else self._correlation(xs, ys)

    @staticmethod
    def expected_correlation(weight, num_metrics, metric_std, aggregate_std):
        """Variance-aware expectation for a metric's correlation with the
        aggregate: r ~= weight * sqrt(num_metrics) * metric_std/aggregate_std,
        capped at 0.95 (reference: percentile_normalizer.py:226-244)."""
        if aggregate_std <= 0 or num_metrics == 0:
            return weight
        expected = weight * np.sqrt(num_metrics) * (metric_std / aggregate_std)
        return float(min(0.95, max(0.0, expected)))

    @staticmethod
    def _damp(current, proposed):
        """Cap a weight-percent change at DAMPING_MAX_POINTS per run."""
        delta = proposed - current
        if abs(delta) > DAMPING_MAX_POINTS:
            return current + (DAMPING_MAX_POINTS if delta > 0
                              else -DAMPING_MAX_POINTS)
        return proposed

    # metric column -> category weight key
    METRIC_WEIGHT_KEYS = {
        "aesthetic": "aesthetic",
        "exposure_score": "exposure",
        "tech_sharpness": "tech_sharpness",
        "color_score": "color",
        "comp_score": "composition",
        "contrast_score": "contrast",
        "quality_score": "quality",
        "face_quality": "face_quality",
    }

    def analyze_scoring_issues(self, rows=None):
        """-> list of issue dicts with proposed, damped config changes.
        `rows` lets health_report reuse its already-loaded row set."""
        rows = rows if rows is not None else self._load_rows()
        analysis = self.config.get_analysis_settings()
        issues = []
        if len(rows) < 10:
            return issues

        aggregates = [r["aggregate"] for r in rows]
        agg_std = float(np.std(aggregates))

        # 1. aesthetic ceiling: scores compressed near the top
        aesthetics = [r["aesthetic"] for r in rows if r["aesthetic"] is not None]
        if aesthetics and float(np.mean(aesthetics)) > analysis.get(
                "aesthetic_max_threshold", 9.0):
            issues.append({
                "issue_type": "aesthetic_ceiling",
                "detail": f"mean aesthetic {np.mean(aesthetics):.2f} is"
                          " compressed against the ceiling",
                "target_category": None,
                "target_key": "normalization.percentile_target",
                "old_value": self.target,
                "proposed_value": min(99, self.target + 2),
                "priority": 2,
            })

        # 2. correlation analysis per scope (global + per-category with
        # enough samples): a metric whose measured correlation far exceeds
        # its variance-aware expectation dominates; one whose weight is high
        # but correlation is near zero is dead weight. Spearman is used on
        # large samples to catch monotonic (nonlinear) relationships.
        low_corr_weight = analysis.get("low_corr_weight_threshold", 0.15)
        low_corr_r = analysis.get("low_corr_r_threshold", 0.2)
        min_cat = analysis.get("category_min_samples", self.min_samples)
        num_metrics = len(self.METRIC_WEIGHT_KEYS)

        scopes = [("default", rows)]
        by_category_rows = {}
        for r in rows:
            by_category_rows.setdefault(r["category"], []).append(r)
        for cat, cat_rows in by_category_rows.items():
            if cat and cat != "default" and len(cat_rows) >= min_cat:
                scopes.append((cat, cat_rows))

        for scope, scope_rows in scopes:
            scope_aggs = [r["aggregate"] for r in scope_rows]
            scope_agg_std = float(np.std(scope_aggs)) or 1.0
            weights = self.config.get_weights(scope)
            for metric, key in self.METRIC_WEIGHT_KEYS.items():
                pairs = [(r["aggregate"], r[metric]) for r in scope_rows
                         if isinstance(r.get(metric), (int, float))]
                if len(pairs) < 10:
                    continue
                xs = [p[1] for p in pairs]
                ys = [p[0] for p in pairs]
                corr = self._metric_correlation(xs, ys)
                if corr is None:
                    continue
                weight = weights.get(key, 0.0)
                expected = self.expected_correlation(
                    weight, num_metrics, float(np.std(xs)), scope_agg_std)
                current = self._current_weight(scope, key)
                scope_label = "" if scope == "default" else f" in '{scope}'"
                dominant_threshold = analysis.get(
                    "correlation_dominant_threshold", 0.5)
                # dominant: measured correlation well above the variance-aware
                # expectation for this weight (reference: pn.py:683-686)
                if corr > dominant_threshold and corr > expected + 0.15 \
                        and current > DAMPING_MAX_POINTS:
                    issues.append({
                        "issue_type": "dominant_metric",
                        "detail": f"{metric} correlates {corr:.2f} with the"
                                  f" aggregate{scope_label} (expected"
                                  f" ~{expected:.2f}) — reduce its weight",
                        "target_category": scope,
                        "target_key": f"{key}_percent",
                        "old_value": current,
                        "proposed_value": self._damp(
                            current, current - DAMPING_MAX_POINTS),
                        "priority": 1,
                    })
                # dead weight: big weight, no relationship to the aggregate
                elif weight >= low_corr_weight and abs(corr) < low_corr_r \
                        and current > DAMPING_MAX_POINTS:
                    issues.append({
                        "issue_type": "low_correlation",
                        "detail": f"{metric} holds {current}% weight"
                                  f"{scope_label} but correlates only"
                                  f" {corr:.2f} with the aggregate — dead"
                                  " weight",
                        "target_category": scope,
                        "target_key": f"{key}_percent",
                        "old_value": current,
                        "proposed_value": self._damp(
                            current, current - DAMPING_MAX_POINTS),
                        "priority": 2,
                    })

        # 2b. underutilized signal: the quality model scores high on average
        # but carries little weight (reference: underutilized_signal)
        quality_vals = [r["quality_score"] for r in rows
                        if isinstance(r.get("quality_score"), (int, float))]
        if quality_vals:
            qual_avg = float(np.mean(quality_vals))
            qual_corr = self._metric_correlation(
                quality_vals,
                [r["aggregate"] for r in rows
                 if isinstance(r.get("quality_score"), (int, float))]) or 0.0
            qual_weight = self._current_weight("default", "quality")
            if qual_avg > analysis.get("quality_avg_threshold", 7.5) \
                    and qual_weight <= analysis.get(
                        "quality_weight_threshold_percent", 10) \
                    and qual_corr <= analysis.get(
                        "correlation_dominant_threshold", 0.5):
                issues.append({
                    "issue_type": "underutilized_signal",
                    "detail": f"quality model averages {qual_avg:.2f} but"
                              f" holds only {qual_weight}% weight — raise it",
                    "target_category": "default",
                    "target_key": "quality_percent",
                    "old_value": qual_weight,
                    "proposed_value": self._damp(
                        qual_weight, qual_weight + DAMPING_MAX_POINTS),
                    "priority": 2,
                })

        # 3. score clustering: everything lands in a narrow band
        if agg_std < analysis.get("score_clustering_std_threshold", 1.0):
            issues.append({
                "issue_type": "score_clustering",
                "detail": f"aggregate std {agg_std:.2f} — scores are"
                          " clustered; widen discriminative weights",
                "target_category": "default",
                "target_key": "aesthetic_percent",
                "old_value": self._current_weight("default", "aesthetic"),
                "proposed_value": min(60, self._current_weight("default",
                                                               "aesthetic")
                                      + DAMPING_MAX_POINTS),
                "priority": 3,
            })

        # 4. exposure too generous
        exposures = [r["exposure_score"] for r in rows
                     if r["exposure_score"] is not None]
        if exposures and float(np.mean(exposures)) > analysis.get(
                "exposure_avg_threshold", 8.0):
            current = self._current_weight("default", "exposure")
            if current > DAMPING_MAX_POINTS:
                issues.append({
                    "issue_type": "exposure_generous",
                    "detail": f"mean exposure {np.mean(exposures):.2f} adds"
                              " little signal — reduce its weight",
                    "target_category": "default",
                    "target_key": "exposure_percent",
                    "old_value": current,
                    "proposed_value": current - DAMPING_MAX_POINTS,
                    "priority": 2,
                })

        # 5. category imbalance
        by_cat = {}
        for r in rows:
            by_cat[r["category"]] = by_cat.get(r["category"], 0) + 1
        if by_cat:
            top_share = max(by_cat.values()) / len(rows)
            if top_share > analysis.get("category_imbalance_threshold", 0.5) \
                    and len(by_cat) > 1 and max(by_cat, key=by_cat.get) == "default":
                issues.append({
                    "issue_type": "category_imbalance",
                    "detail": f"{top_share:.0%} of photos fall through to"
                              " 'default' — tagging may be under-enabled",
                    "target_category": None,
                    "target_key": None,
                    "old_value": None,
                    "proposed_value": None,
                    "priority": 4,
                })

        # conflict resolution: one change per (category, key), best priority
        seen = {}
        for issue in sorted(issues, key=lambda i: i["priority"]):
            key = (issue["target_category"], issue["target_key"])
            if key not in seen:
                seen[key] = issue
        resolved = list(seen.values())

        # oscillation guard: don't re-propose a recently reverted change
        return [i for i in resolved if not self._oscillates(i)]

    def _current_weight(self, category, key):
        cat = self.config.get_category_config(category)
        return (cat.get("weights") or {}).get(f"{key}_percent", 0)

    def _oscillates(self, issue):
        if not issue.get("target_key"):
            return False
        with get_connection(self.db_path) as conn:
            rows = conn.execute(
                "SELECT old_value, proposed_value FROM recommendation_history"
                " WHERE IFNULL(target_category, '') = IFNULL(?, '')"
                " AND target_key = ? ORDER BY run_timestamp DESC LIMIT ?",
                (issue["target_category"], issue["target_key"],
                 OSCILLATION_WINDOW)).fetchall()
        for old, proposed in rows:
            # proposing to undo what a previous run proposed = oscillation
            if proposed is not None and issue["proposed_value"] is not None \
                    and old is not None:
                if (proposed - old) * (issue["proposed_value"]
                                       - issue["old_value"]) < 0:
                    return True
        return False

    # -------------------------------------------------------------- health

    def health_report(self):
        rows = self._load_rows()
        issues = self.analyze_scoring_issues(rows=rows)
        if not rows:
            return {"photos": 0, "health_score": None, "issues": []}
        aggregates = [r["aggregate"] for r in rows]
        health = 100
        health -= 15 * len([i for i in issues if i["priority"] <= 2])
        health -= 5 * len([i for i in issues if i["priority"] > 2])
        return {
            "photos": len(rows),
            "aggregate_mean": round(float(np.mean(aggregates)), 3),
            "aggregate_std": round(float(np.std(aggregates)), 3),
            "health_score": max(0, health),
            "issues": issues,
        }

    def metric_statistics(self, category="default"):
        """Per-metric weight / measured correlation / variance-aware
        expected correlation table (the --compute-recommendations --verbose
        detail; reference photos.py:144-145)."""
        rows = self._load_rows()
        if category != "default":
            rows = [r for r in rows if r["category"] == category]
        if not rows:
            return []
        aggs = [r["aggregate"] for r in rows]
        agg_std = float(np.std(aggs)) or 1.0
        weights = self.config.get_weights(category)
        num = len(self.METRIC_WEIGHT_KEYS)
        out = []
        for metric, key in self.METRIC_WEIGHT_KEYS.items():
            pairs = [(r["aggregate"], r[metric]) for r in rows
                     if isinstance(r.get(metric), (int, float))]
            if len(pairs) < 2:
                continue
            xs = [p[1] for p in pairs]
            ys = [p[0] for p in pairs]
            corr = self._metric_correlation(xs, ys)
            weight = weights.get(key, 0.0)
            out.append({
                "metric": metric,
                "weight": weight,
                "correlation": corr,
                "expected": self.expected_correlation(
                    weight, num, float(np.std(xs)), agg_std),
                "samples": len(pairs),
            })
        return out

    # ----------------------------------------------------- simulate / apply

    def _record_history(self, issues, applied):
        with get_connection(self.db_path) as conn:
            for issue in issues:
                if not issue.get("target_key"):
                    continue
                conn.execute(
                    "INSERT INTO recommendation_history (config_version_hash,"
                    " issue_type, target_category, target_key, old_value,"
                    " proposed_value, was_applied) VALUES (?, ?, ?, ?, ?, ?, ?)",
                    (self.config.version_hash, issue["issue_type"],
                     issue["target_category"], issue["target_key"],
                     issue["old_value"], issue["proposed_value"],
                     1 if applied else 0))

    def simulate_recommendations(self, issues=None):
        """Project the aggregate distribution under the proposed changes."""
        import copy

        from facet_tpu_torch.config.scoring_config import ScoringConfig
        from facet_tpu_torch.scoring.vectorized import AggregateScorer

        issues = issues if issues is not None else self.analyze_scoring_issues()
        weight_changes = [i for i in issues
                          if (i.get("target_key") or "").endswith("_percent")
                          and i.get("target_category")]
        from facet_tpu_torch.processing.scorer import ROW_COLUMNS

        cols = ", ".join(c for c in ROW_COLUMNS if c != "thumbnail")
        with get_connection(self.db_path) as conn:
            rows = [dict(r) for r in conn.execute(
                f"SELECT {cols} FROM photos WHERE aggregate IS NOT NULL")]
        if not rows:
            return {"photos": 0}

        before = np.array([r["aggregate"] for r in rows])
        sim_config = ScoringConfig(self.config.config_path, validate=False)
        sim_config.config = copy.deepcopy(self.config.config)
        for issue in weight_changes:
            cat = sim_config.get_category_config(issue["target_category"])
            if cat:
                cat.setdefault("weights", {})[issue["target_key"]] = \
                    issue["proposed_value"]
        scores, _ = AggregateScorer(sim_config).score_rows(rows)
        return {
            "photos": len(rows),
            "changes": len(weight_changes),
            "mean_before": round(float(before.mean()), 3),
            "mean_after": round(float(scores.mean()), 3),
            "std_before": round(float(before.std()), 3),
            "std_after": round(float(scores.std()), 3),
        }

    def apply_recommendations(self, issues=None):
        """Write proposed changes into the config (after a file backup)."""
        issues = issues if issues is not None else self.analyze_scoring_issues()
        applicable = [i for i in issues if i.get("target_key")]
        if not applicable:
            return 0
        backup = f"{self.config.config_path}.backup_{time.strftime('%Y%m%d_%H%M%S')}"
        try:
            shutil.copy2(self.config.config_path, backup)
        except OSError:
            pass
        for issue in applicable:
            if issue["target_key"] == "normalization.percentile_target":
                self.config.config.setdefault("normalization", {})[
                    "percentile_target"] = issue["proposed_value"]
            elif issue["target_category"]:
                cat = self.config.get_category_config(issue["target_category"])
                if cat:
                    cat.setdefault("weights", {})[issue["target_key"]] = \
                        issue["proposed_value"]
        self.config.validate_weights(verbose=False)
        self.config.save_config()
        self._record_history(applicable, applied=True)
        return len(applicable)


# --------------------------------------------------------------- tuner


def recalculate_batch_settings(measured_mb_per_sec, measured_imgs_per_sec,
                               device_imgs_per_sec=150.0, current_workers=4,
                               min_workers=1, max_workers=24):
    """IO-vs-device bottleneck tuner (reference: percentile_normalizer.py:
    2185-2260, updated for TPU throughput).

    If the host decode pipeline delivers fewer images/sec than the device can
    score, add workers; if the host overruns the device, shed workers.
    """
    if measured_imgs_per_sec <= 0:
        return {"workers": current_workers, "bottleneck": "unknown"}
    if measured_imgs_per_sec < device_imgs_per_sec * 0.8:
        workers = min(max_workers, current_workers + 2)
        bottleneck = "io"
    elif measured_imgs_per_sec > device_imgs_per_sec * 1.5 \
            and current_workers > min_workers:
        workers = max(min_workers, current_workers - 1)
        bottleneck = "device"
    else:
        workers = current_workers
        bottleneck = "balanced"
    return {"workers": workers, "bottleneck": bottleneck,
            "host_imgs_per_sec": measured_imgs_per_sec,
            "device_imgs_per_sec": device_imgs_per_sec,
            "mb_per_sec": measured_mb_per_sec}


# ----------------------------------------------------------- CLI driver


def run_recommendations(db_path, config, apply=False, simulate=False,
                        verbose=False):
    normalizer = PercentileNormalizer(db_path, config)
    report = normalizer.health_report()
    print(f"scoring health: {report.get('health_score')}/100 over"
          f" {report['photos']} photos"
          f" (mean {report.get('aggregate_mean')},"
          f" std {report.get('aggregate_std')})")
    if verbose:
        stats = normalizer.metric_statistics()
        if stats:
            print(f"{'metric':<24} {'weight':>7} {'corr':>7} "
                  f"{'expected':>9} {'n':>6}")
            for s in stats:
                corr = f"{s['correlation']:.3f}" \
                    if s["correlation"] is not None else "-"
                print(f"{s['metric']:<24} {s['weight']:>7.3f} {corr:>7} "
                      f"{s['expected']:>9.3f} {s['samples']:>6}")
    issues = report["issues"]
    if not issues:
        print("no recommendations — scoring looks healthy")
        return 0
    for issue in issues:
        print(f"  [{issue['issue_type']}] {issue['detail']}")
        if issue.get("target_key"):
            print(f"    -> {issue['target_category'] or 'global'}."
                  f"{issue['target_key']}: {issue['old_value']}"
                  f" -> {issue['proposed_value']}")
    if simulate:
        projection = normalizer.simulate_recommendations(issues)
        print(f"simulation: mean {projection.get('mean_before')}"
              f" -> {projection.get('mean_after')},"
              f" std {projection.get('std_before')}"
              f" -> {projection.get('std_after')}")
    if apply:
        n = normalizer.apply_recommendations(issues)
        print(f"applied {n} changes (config backed up);"
              " run --recompute-average to rescore")
    else:
        normalizer._record_history(issues, applied=False)
    return 0
