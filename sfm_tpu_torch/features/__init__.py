"""Image features: detection, description and matching."""
