"""Tag string helpers (reference: utils/tags.py)."""


def tags_to_string(tags):
    """List of tags (or (tag, score) pairs) -> display string."""
    names = [t[0] if isinstance(t, (tuple, list)) else t for t in tags]
    return ", ".join(names)


def string_to_tags(tags_str):
    if not tags_str:
        return []
    return [t.strip() for t in tags_str.split(",") if t.strip()]
