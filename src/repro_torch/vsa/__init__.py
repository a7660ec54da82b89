"""Vector-symbolic algebra on block codes."""
