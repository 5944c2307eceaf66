"""Scene pipelines: raw EMIT granule to plume mask."""
