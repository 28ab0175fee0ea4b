"""SLAM models: map, frame, tracking, local mapping, system facade."""
