"""Sharding rules: spec trees and DTensor placements (port of
`repro.sharding`)."""
