from .index import EntityIndex, Entity
