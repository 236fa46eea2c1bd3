"""Host BVH builders."""
