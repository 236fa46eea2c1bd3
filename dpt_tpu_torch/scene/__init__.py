"""Scene containers, camera and procedural scene builders."""
